"""The cases of tests/test_torch_mesh.py and the body each gloo rank runs.

A spawned rank imports this module by name, so it imports nothing of JAX
and nothing of ``phdslam_tpu`` (``loaded_reference_modules`` lets the test
check that). ``run_case(case)`` runs a case in the single process;
``run_case(case, mesh)`` runs it on a rank of a mesh. Both return the same
flat dict of numpy arrays (the global values), so the parent compares
them key by key. A rank also keeps, for each case, the mesh's traffic
record of every step (taken before the step's log values are gathered)
and the leading dimension each kernel entry received (``kernel_rows``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import sys

import numpy as np
import torch
import torch.multiprocessing as mp

from phdslam_tpu_torch import load_config, simdata
from phdslam_tpu_torch.filter import disparity as TD
from phdslam_tpu_torch.filter import step as TS
from phdslam_tpu_torch.filter.state import Measurements, SlamState
from phdslam_tpu_torch.kernels import _build
from phdslam_tpu_torch.parallel import island as TI
from phdslam_tpu_torch.parallel import mesh as TM

TINY = dict(n_particles=32, maxFeatures=16, maxMeasurements=8,
            birthWeight=0.02, y0=0.0)
KINDS = {
    "static": ("cfg/ackerman_synth.cfg", TINY),
    "cphd": ("cfg/ackerman_synth.cfg",
             {**TINY, "filterType": 1, "maxCardinality": 16}),
    "mixed": ("cfg/mixed_synth.cfg", TINY),
    "fastslam": ("cfg/fastslam_synth.cfg", TINY),
    "shotgun": ("cfg/ackerman_synth.cfg", {**TINY, "nPredictParticles": 2}),
    "disparity": ("cfg/disparity_synth.cfg",
                  dict(n_particles=32, maxFeatures=8, particlesPerFeature=8,
                       maxMeasurements=8)),
}
T_STEPS = 3


def config(kind, **over):
    path, kw = KINDS[kind]
    return load_config(path).replace(**{**kw, **over})


def inputs(cfg, n_steps):
    """A simdata run's padded measurement sets (Measurements on the CPU)
    and its controls, the first step's zero."""
    sc = simdata.make_scenario(np.random.default_rng(11), n_landmarks=12,
                               n_steps=n_steps + 2, clutter_rate=2.0)
    controls, meas = simdata.generate_run(np.random.default_rng(12), sc,
                                          control_noise=(0.05, 0.005))
    M = cfg.maxMeasurements
    zs = []
    for t in range(n_steps):
        rb = np.zeros((M, 2), np.float32)
        k = min(len(meas[t]), M)
        rb[:k] = meas[t][:k]
        zs.append(Measurements.from_numpy(rb, np.zeros(M, np.int32),
                                          np.arange(M) < k))
    ctrls = [(0.0, 0.0)] + [(float(c[0]), float(c[1]))
                            for c in controls[:n_steps - 1]]
    return zs, ctrls


def disparity_inputs(cfg, n_steps):
    sc = simdata.make_disparity_scenario(np.random.default_rng(3),
                                         n_landmarks=8, n_steps=n_steps)
    meas = simdata.generate_disparity_run(np.random.default_rng(4), sc)
    M = cfg.maxMeasurements
    zs = []
    for t in range(n_steps):
        uv = np.zeros((M, 2), np.float32)
        k = min(len(meas[t]), M)
        uv[:k] = meas[t][:k]
        zs.append(Measurements.from_numpy(uv, np.zeros(M, np.int32),
                                          np.arange(M) < k))
    return zs


def flat(obj, prefix=""):
    """Every tensor of a tree of NamedTuples, dataclasses, tuples and
    dicts as numpy, keyed by its path."""
    out = {}
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj.detach().cpu().numpy()
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(flat(getattr(obj, f.name), f"{prefix}.{f.name}"))
    elif hasattr(obj, "_asdict"):
        for k, v in obj._asdict().items():
            out.update(flat(v, f"{prefix}.{k}"))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            out.update(flat(v, f"{prefix}.{k}"))
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            out.update(flat(v, f"{prefix}.{i}"))
    return out


@contextlib.contextmanager
def kernel_rows():
    """Within: every kernel entry (``_build.kernel_for``'s callers) notes
    the leading dimension of its first tensor argument (a list's first
    tensor) in the yielded dict, {kernel: set of sizes}."""
    rows, kernel_for = {}, _build.kernel_for

    def noting(device, cuda_fn, plain_fn, what):
        run = kernel_for(device, cuda_fn, plain_fn, what)

        def call(*args, **kw):
            first = args[0][0] if isinstance(args[0], (list, tuple)) \
                else args[0]
            rows.setdefault(what, set()).add(int(first.shape[0]))
            return run(*args, **kw)

        return call

    _build.kernel_for = noting
    try:
        yield rows
    finally:
        _build.kernel_for = kernel_for


def run_case(case, mesh=None, traffic=None):
    """One case: kind (a KINDS key), thresh (resampleThresh, or the island
    exchange's), steps; over (more cfg overrides of a plain step or scan,
    e.g. n_particles); islands (n), scan (run_scan with its log), noises
    (global draws to replay, one per step; without them the draws come
    from a generator seeded 0) and z_prev (False: no previous set, as
    JAX's sharded_step is called). Returns flat(...) of every step's aux and
    log values and the final global state. With a mesh and a list
    ``traffic``, the mesh's traffic record of each step is appended to it
    (of the whole run for a scan)."""
    kind, thresh = case["kind"], case["thresh"]
    n_steps = case.get("steps", T_STEPS)
    gen = torch.Generator().manual_seed(0)
    noises = case.get("noises")
    every = TM.everywhere(mesh)[0]
    shard = (lambda s: s) if mesh is None else \
        (lambda s: TM.shard_state(s, mesh))

    def record(run):
        """run(), the mesh's traffic record of it appended to traffic."""
        if mesh is not None:
            mesh.take_traffic()
        out = run()
        if mesh is not None and traffic is not None:
            traffic.append(mesh.take_traffic())
        return out

    if kind == "disparity":
        cfg = config(kind, resampleThresh=thresh)
        zs = disparity_inputs(cfg, n_steps)
        state = shard(TD.DisparityState.create(cfg))
        if case.get("scan"):
            state, outs = record(lambda: TD.run_disparity_scan(
                state, zs, float(cfg.dt), cfg, generator=gen,
                with_map_log=True, mesh=mesh))
            return flat(dict(outs=outs, state=every_state(state, mesh)))
        step = (lambda *a, **kw: TD.disparity_step(*a, cfg, **kw)) \
            if mesh is None else TM.sharded_disparity_step(cfg, mesh)
        steps = []
        for t, z in enumerate(zs):
            state, aux = record(lambda: step(state, z, float(cfg.dt), t > 0,
                                             generator=gen))
            steps.append((aux, TD.map_summary(state, mesh),
                          every(state.log_weights)))
        return flat(dict(steps=steps, state=every_state(state, mesh)))

    zs, ctrls = inputs(config("static"), n_steps)
    if case.get("islands"):
        n = case["islands"]
        cfg = config(kind)
        state, ilw = TI.init_islands(cfg, n)
        state = shard(state)
        steps, prev = [], None
        for t in range(n_steps):
            state, ilw, aux = record(lambda: TI.island_slam_step(
                state, ilw, ctrls[t], zs[t], float(cfg.dt), t > 0, cfg, n,
                thresh=thresh, generator=gen, z_prev=prev,
                noise=None if noises is None else noises[t], mesh=mesh))
            # what with_log_state=True appends, apart from the step's record
            steps.append((aux, TI.island_log_aux(state, ilw, n, mesh)))
            prev = zs[t]
        return flat(dict(steps=steps, ilw=ilw,
                         state=every_state(state, mesh)))

    cfg = config(kind, resampleThresh=thresh, **case.get("over", {}))
    state = shard(SlamState.create(cfg))
    if case.get("scan"):
        if mesh is None:
            state, outs = TS.run_scan(state, ctrls, zs, [cfg.dt] * n_steps,
                                      cfg, generator=gen,
                                      with_log_state=True)
        else:
            run = TM.sharded_run_scan(cfg, mesh, with_log_state=True)
            state, outs = record(lambda: run(
                state, ctrls, zs, [cfg.dt] * n_steps, generator=gen))
        return flat(dict(outs=outs, state=every_state(state, mesh)))
    step = (lambda *a, **kw: TS.slam_step(*a[:5], cfg, **kw)) \
        if mesh is None else TM.sharded_step(cfg, mesh)
    steps, prev = [], None
    for t in range(n_steps):
        state, aux = record(lambda: step(
            state, ctrls[t], zs[t], float(cfg.dt), t > 0, generator=gen,
            z_prev=prev if case.get("z_prev", True) else None,
            noise=None if noises is None else noises[t]))
        steps.append((aux, TS.log_aux(state, mesh=mesh)))
        prev = zs[t]
    return flat(dict(steps=steps, state=every_state(state, mesh)))


def every_state(state, mesh):
    return state if mesh is None else TM.unshard_state(state, mesh)


def loaded_reference_modules():
    """The modules of JAX or of the JAX package this process has loaded,
    by name or by a file under ``phdslam_tpu/``."""
    jax_pkg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "phdslam_tpu", "")
    return sorted(
        n for n, m in list(sys.modules.items())
        if n.split(".")[0] in ("jax", "jaxlib", "flax", "phdslam_tpu")
        or os.path.abspath(getattr(m, "__file__", None) or "").startswith(
            jax_pkg))


def _rank(rank, world, init_file, job_path, out_path):
    torch.set_num_threads(1)
    mesh = TM.make_mesh(device="cpu", rank=rank, world_size=world,
                        init_method=f"file://{init_file}")
    try:
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        res, extras = {}, {}
        for name, case in job.items():
            traffic = []
            with kernel_rows() as rows:
                res[name] = run_case(case, mesh, traffic)
            extras[name] = dict(traffic=traffic, rows=rows)
        res["__extras__"] = extras
        res["__reference_modules__"] = loaded_reference_modules()
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(res, f)
    finally:
        mesh.close()


def run_ranks(job: dict, world: int, tmp_dir) -> dict:
    """Run every case of job (name -> case) on ``world`` gloo ranks on the
    CPU (spawned processes, a file rendezvous in tmp_dir); returns rank
    0's results by name. A failure in any rank raises here."""
    tmp_dir = os.fspath(tmp_dir)
    job_path = os.path.join(tmp_dir, f"job{world}.pkl")
    out_path = os.path.join(tmp_dir, f"out{world}.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    mp.spawn(_rank, args=(world, os.path.join(tmp_dir, f"rdv{world}"),
                          job_path, out_path), nprocs=world, join=True)
    with open(out_path, "rb") as f:
        return pickle.load(f)

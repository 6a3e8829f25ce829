#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (phdslam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, nvcc and
PyTorch; JAX is neither needed nor imported. Phases, each printing its
result and its seconds on its own line; any failure raises, so the exit
code is not 0:

  1. build  - compile csrc/*.cu with nvcc for sm_90a (set-up time)
  2. select / merge kernels against their plain PyTorch versions on the
     card: Kernel 1 at the shipped (256 x 128 x 64) and dense
     (8192 x 512 x 64) shapes, Kernel 2 on the dense pool
     ([8192, 1088] -> 512, metrics 0 and 1), the shipped pool
     ([256, 704] -> 128) and at an odd P and odd cap.
     Values are held to rtol 2e-4 / atol 1e-5; a particle whose outputs
     miss that (a near-tie picked in another order) is counted, and the
     phase fails above 0.1 % of the particles.
  3. main path - the runner (loop mode, --device cuda) over a 330-step
     simdata run at cfg/ackerman_synth.cfg: the log contract, each kernel
     launched once per update step, mean pose error below 1.5 m, and both
     kernels against their plain versions on the run's last launch
  4. dense step - 8192 x 512 x 64 (the shipped cfg at bench.py's dense
     shape and stress stream): 3 warm-up steps, 16 timed with CUDA events,
     split into pre-update and glue, Kernel 1 and Kernel 2; then both
     kernels against their plain versions on the last step's own inputs
  5. the kernels' JSON line, then {"ok": true, "device": {...}} last

    python3 chip_smoke.py --profile

adds, before the JSON lines, a torch.profiler pass over the step at the
dense and the shipped shape: host wall time, the device's busy share and
the ops with the most device time (the breakdown in PERF.md).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RTOL, ATOL = 2e-4, 1e-5
MAX_DIFFER = 1e-3                   # share of particles allowed to differ
SHIPPED = dict(P=256, F=128, M=64)
DENSE = dict(P=8192, F=512, M=64)
DENSE_CHUNK = 512                   # particles per plain-select comparison
MERGE_CASES = [                     # (P, K, cap, metric, min_separation)
    (8192, 1088, 512, 0, 5.0),
    (256, 704, 128, 0, 5.0),        # the shipped cfg's pool: F + M k1 + M
    (8192, 1088, 512, 1, 0.6),
    (1001, 1088, 512, 0, 5.0),      # odd P
    (512, 1088, 77, 0, 5.0),        # odd cap
]
RUN_STEPS = 330
POSE_BAR_M = 1.5
WARMUP, TIMED = 3, 16
PROFILE_WARMUP, PROFILED, PROFILE_ROWS = 8, 4, 12


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phase 2 --

def random_select_inputs(P, F, M, seed, dev):
    """Kernel-1 inputs from kalman_preupdate on a seeded random map and
    measurement set (about half the slots live, features within 10 m)."""
    import torch
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.filter.state import Gaussian2DMixture
    from phdslam_tpu_torch.filter.update import kalman_preupdate

    rng = np.random.default_rng(seed)
    cfg = load_config(str(ROOT / "cfg/ackerman_synth.cfg")).replace(
        n_particles=P, maxFeatures=F, maxMeasurements=M)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    w = (rng.uniform(size=(P, F)) < 0.5) * rng.uniform(0.05, 1.0, (P, F))
    c00 = rng.uniform(0.1, 2.0, (P, F))
    c11 = rng.uniform(0.1, 2.0, (P, F))
    gm = Gaussian2DMixture(
        w=t(w), mx=t(rng.uniform(-2, 12, (P, F))),
        my=t(rng.uniform(-10, 10, (P, F))), c00=t(c00),
        c01=t(0.3 * np.sqrt(c00 * c11) * rng.uniform(-1, 1, (P, F))),
        c11=t(c11))
    pose = t(np.concatenate([rng.normal(0, 0.3, (P, 2)),
                             rng.normal(0, 0.05, (P, 1)),
                             np.zeros((P, 3))], axis=1))
    z = t(np.stack([rng.uniform(0.5, cfg.maxRange, M),
                    rng.uniform(-cfg.maxBearing, cfg.maxBearing, M)], 1))
    return cfg, kalman_preupdate(pose, gm, cfg), gm, z


def compare_rows(kern, plain, live=None):
    """Per-particle agreement of output tensors (leading axis P) within
    rtol/atol. live: optional mask per tensor of the entries to compare.
    Returns (particles that differ, max abs error over the others)."""
    import torch
    bad = errs = None
    for i, (k, p) in enumerate(zip(kern, plain)):
        if k.dtype == torch.bool:
            ok = k == p
            err = torch.zeros_like(k, dtype=torch.float32)
        else:
            ok = torch.isclose(k, p, rtol=RTOL, atol=ATOL)
            err = (k - p).abs()
        if live is not None and live[i] is not None:
            ok = ok | ~live[i]
            err = torch.where(live[i], err, 0.0)
        row_bad = ~ok.reshape(ok.shape[0], -1).all(1)
        row_err = err.reshape(err.shape[0], -1).amax(1)
        bad = row_bad if bad is None else bad | row_bad
        errs = row_err if errs is None else torch.maximum(errs, row_err)
    return int(bad.sum()), float(torch.where(bad, 0.0, errs).max())


def select_outputs_agree(kern, plain):
    """sum, 7 selection channels, compat: payload compared where the plain
    version picked a live (w > 0) term."""
    live_w = plain[1] > 0
    live = [None, None] + [live_w] * 6 + [None]
    return compare_rows(kern, plain, live)


def phase_select(dev, stats):
    from phdslam_tpu_torch.kernels import select as S

    t0 = time.perf_counter()
    worst = 0.0
    cases = [dict(raw=False, with_compat=True, with_lpw=True, nv=None),
             dict(raw=True, with_compat=False, with_lpw=False, nv=None),
             dict(raw=False, with_compat=True, with_lpw=True, nv=41)]
    P, F, M = SHIPPED["P"], SHIPPED["F"], SHIPPED["M"]
    cfg, pre, gm, z = random_select_inputs(P, F, M, 1, dev)
    for case in cases:
        chans, kw, nv = _select_args(S, cfg, pre, gm, z, case)
        kern = S.select_cuda(chans, z, nv, **kw)
        plain = S.select_plain(chans, z, nv, **kw)
        n_bad, err = select_outputs_agree(kern, plain)
        worst = max(worst, err)
        log(f"select {P}x{F}x{M} raw={case['raw']} "
            f"compat={case['with_compat']} lpw={case['with_lpw']} "
            f"n_valid={int(nv)}: particles differing {n_bad}/{P}, "
            f"max_abs_err {err:.3e}")
        _limit(n_bad, P, "select (shipped shape)")
    chans, kw, nv = _select_args(S, cfg, pre, gm, z, cases[0])
    ms_shipped = cuda_ms(lambda: S.select_cuda(chans, z, nv, **kw), 20)
    plain_shipped = cuda_ms(lambda: S.select_plain(chans, z, nv, **kw), 5)

    P, F, M = DENSE["P"], DENSE["F"], DENSE["M"]
    cfg, pre, gm, z = random_select_inputs(P, F, M, 2, dev)
    chans, kw, nv = _select_args(S, cfg, pre, gm, z, cases[0])
    kern = S.select_cuda(chans, z, nv, **kw)
    n_bad = 0
    for lo in range(0, P, DENSE_CHUNK):
        part = [c[lo:lo + DENSE_CHUNK] for c in chans]
        plain = S.select_plain(part, z, nv, **kw)
        b, err = select_outputs_agree([k[lo:lo + DENSE_CHUNK] for k in kern],
                                      plain)
        n_bad += b
        worst = max(worst, err)
    log(f"select {P}x{F}x{M} (chunks of {DENSE_CHUNK}): particles "
        f"differing {n_bad}/{P}, max_abs_err {worst:.3e}")
    _limit(n_bad, P, "select (dense shape)")
    ms = cuda_ms(lambda: S.select_cuda(chans, z, nv, **kw), 10)
    plain_ms = cuda_ms(lambda: S.select_plain(chans, z, nv, **kw), 3)
    log(f"select timing: dense {ms:.4f} ms (plain {plain_ms:.3f} ms), "
        f"shipped {ms_shipped:.4f} ms (plain {plain_shipped:.3f} ms)")
    stats["select"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                           ms_shipped=ms_shipped,
                           plain_ms_shipped=plain_shipped)
    log(f"phase select: ok ({time.perf_counter() - t0:.1f} s)")


def _select_args(S, cfg, pre, gm, z, case):
    import torch
    M = z.shape[0]
    nv = torch.tensor([case["nv"] or M], dtype=torch.int32, device=z.device)
    chans = [c.contiguous() for c in S.select_channels(pre, gm)]
    kw = dict(k1=8, clutter_birth=float(cfg.clutterDensity
                                        + cfg.birthWeight),
              min_weight=float(cfg.minFeatureWeight),
              gate_threshold=float(cfg.gateThreshold), raw=case["raw"],
              with_compat=case["with_compat"], with_lpw=case["with_lpw"])
    return chans, kw, nv


def random_pool(P, K, seed, dev):
    """A seeded candidate pool: ~60 % live weights, means in a 40 m box."""
    import torch
    rng = np.random.default_rng(seed)
    w = (rng.uniform(size=(P, K)) < 0.6) * rng.uniform(0.01, 2.0, (P, K))
    c00 = rng.uniform(0.05, 1.5, (P, K))
    c11 = rng.uniform(0.05, 1.5, (P, K))
    arrs = (w, rng.uniform(-20, 20, (P, K)), rng.uniform(-20, 20, (P, K)),
            c00, 0.3 * np.sqrt(c00 * c11) * rng.uniform(-1, 1, (P, K)), c11)
    return [torch.as_tensor(np.asarray(a, np.float32), device=dev)
            for a in arrs]


def phase_merge(dev, stats):
    from phdslam_tpu_torch.kernels import merge as G

    t0 = time.perf_counter()
    worst = 0.0
    times = []
    for i, (P, K, cap, metric, sep) in enumerate(MERGE_CASES):
        pool = random_pool(P, K, 10 + i, dev)
        kern = G.merge_cuda(*pool, sep, cap, metric)
        plain = G.merge_plain(*pool, sep, cap, metric)
        n_bad, err = compare_rows(kern, plain)
        worst = max(worst, err)
        log(f"merge [{P}, {K}] -> {cap} metric {metric}: particles "
            f"differing {n_bad}/{P}, max_abs_err {err:.3e}, live slots "
            f"{int((plain[0] > 0).sum(1).max())} max")
        _limit(n_bad, P, f"merge metric {metric}")
        if i < 2:                   # the dense and the shipped pool
            times.append((
                cuda_ms(lambda: G.merge_cuda(*pool, sep, cap, metric), 5),
                cuda_ms(lambda: G.merge_plain(*pool, sep, cap, metric), 2)))
    (ms, plain_ms), (ms_shipped, plain_shipped) = times
    log(f"merge timing: dense pool {ms:.3f} ms (plain {plain_ms:.3f} ms), "
        f"shipped pool {ms_shipped:.4f} ms (plain {plain_shipped:.3f} ms)")
    stats["merge"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                          ms_shipped=ms_shipped,
                          plain_ms_shipped=plain_shipped)
    log(f"phase merge: ok ({time.perf_counter() - t0:.1f} s)")


def _limit(n_bad, P, what):
    if n_bad > MAX_DIFFER * P:
        raise RuntimeError(f"{what}: {n_bad} of {P} particles differ from "
                           f"the plain version (limit {MAX_DIFFER:.1%})")


def agree_on_last_args(k1, k2, stats, what):
    """Run the select (k1) and merge (k2) kernels and their plain versions
    again on the arguments of their last recorded launch."""
    from phdslam_tpu_torch.kernels import merge as G
    from phdslam_tpu_torch.kernels import select as S

    a, kw = k1.last_args
    P, F = a[0][0].shape
    n_bad, err = select_outputs_agree(S.select_cuda(*a, **kw),
                                      S.select_plain(*a, **kw))
    _limit(n_bad, P, f"select ({what} inputs)")
    a2, kw2 = k2.last_args
    kern = G.merge_cuda(*a2, **kw2)
    K, cap = a2[0].shape[1], kern[0].shape[1]
    n_bad2, err2 = compare_rows(kern, G.merge_plain(*a2, **kw2))
    _limit(n_bad2, P, f"merge ({what} inputs)")
    log(f"{what} inputs: select {P}x{F}x{a[1].shape[0]} particles "
        f"differing {n_bad}/{P} (max_abs_err {err:.3e}), merge [{P}, {K}] "
        f"-> {cap} particles differing {n_bad2}/{P} (max_abs_err "
        f"{err2:.3e})")
    for name, e in (("select", err), ("merge", err2)):
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], e)


# ---------------------------------------------------------------- phase 3 --

class _KernelTimer:
    """Record CUDA events around every launch of one kernel wrapper."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.pairs = []
        self.last_args = None

    def __enter__(self):
        import torch

        def timed(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.orig(*a, **kw)
            e.record()
            self.pairs.append((s, e))
            self.last_args = (a, kw)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def ms(self):
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def phase_main_path(dev, stats):
    from phdslam_tpu_torch import _shared, runner
    from phdslam_tpu_torch.kernels import merge as G
    from phdslam_tpu_torch.kernels import select as S

    t0 = time.perf_counter()
    sc = _shared.make_scenario(np.random.default_rng(0),
                               n_steps=RUN_STEPS)
    controls, meas = _shared.generate_run(np.random.default_rng(1), sc,
                                          control_noise=(0.2, 0.01))
    n_steps = len(meas)
    if not all(len(z) for z in meas):
        raise RuntimeError("scenario has a step without measurements")
    with tempfile.TemporaryDirectory() as d:
        _shared.write_run_files(d, controls, meas)
        base = (ROOT / "cfg/ackerman_synth.cfg").read_text()
        x0, y0, yaw0 = sc.traj[0]
        Path(d, "run.cfg").write_text(
            base + f"\ninitial_x = {x0}\ninitial_y = {y0}\n"
            f"initial_yaw = {yaw0}\n")
        out = Path(d, "out")
        args = [str(Path(d, "run.cfg")), "synth", "--measurements",
                str(Path(d, "measurements.txt")), "--controls",
                str(Path(d, "controls.txt")), "--out-dir", str(out),
                "--mode", "loop", "--device", dev.type]
        S.launches = 0
        G.launches = 0
        t_run = time.perf_counter()
        with _KernelTimer(S, "select_cuda") as k1, \
                _KernelTimer(G, "merge_cuda") as k2:
            runner.main(args)
        run_s = time.perf_counter() - t_run
        launches = dict(select=S.launches, merge=G.launches)
        n_logs = len(list(out.glob("state_estimate*.log")))
        loop_ms = np.loadtxt(out / "loopTime.log")
        errs = np.array([np.linalg.norm(
            _shared.read_state_estimate_log(
                str(out / f"state_estimate{t:05d}.log"))["pose"][:2]
            - sc.traj[t, :2]) for t in range(n_steps)])
    # every step of this run has measurements, so every step updates
    n_update = n_steps
    log(f"main path: {n_steps} steps, {n_logs} state_estimate logs, "
        f"launches select={launches['select']} merge={launches['merge']} "
        f"(update steps {n_update}), pose error mean {errs.mean():.3f} m "
        f"max {errs.max():.3f} m, {loop_ms.mean():.3f} ms/step "
        f"(median {np.median(loop_ms):.3f}, incl. per-step log "
        f"host copies), run {run_s:.1f} s")
    if n_logs != n_steps or len(loop_ms) != n_steps:
        raise RuntimeError("log contract incomplete")
    for k, v in launches.items():
        if v != n_update:
            raise RuntimeError(f"{k} launched {v} times, expected "
                               f"{n_update}")
    if not np.isfinite(errs).all() or errs.mean() >= POSE_BAR_M:
        raise RuntimeError(f"mean pose error {errs.mean():.3f} m is not "
                           f"below {POSE_BAR_M} m")
    # both kernels against their plain versions on the run's last update,
    # at the shapes the shipped cfg gives them
    agree_on_last_args(k1, k2, stats, "main path")
    log(f"main path kernels: select {k1.ms() / n_steps:.4f} ms/step, "
        f"merge {k2.ms() / n_steps:.4f} ms/step (CUDA events)")
    stats["launches"] = launches
    stats["shipped_ms_per_step"] = float(loop_ms.mean())
    log(f"phase main path: ok ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------- phase 4 --

def stress_inputs(cfg, n_steps, seed=0):
    """bench.py's clutter-heavy stream (make_stress_inputs), same seed and
    formula: 90 % of the slots hold uniform clutter each step."""
    rng = np.random.default_rng(seed)
    m = cfg.maxMeasurements
    rb = np.zeros((n_steps, m, 2), np.float32)
    valid = np.zeros((n_steps, m), bool)
    k = int(m * 0.9)
    rb[:, :k, 0] = rng.uniform(0.5, cfg.maxRange, (n_steps, k))
    rb[:, :k, 1] = rng.uniform(-cfg.maxBearing, cfg.maxBearing,
                               (n_steps, k))
    valid[:, :k] = True
    controls = np.zeros((n_steps, 2), np.float32)
    controls[:, 0] = 1.5
    controls[:, 1] = 0.1 * np.sin(np.arange(n_steps) / 10.0)
    return rb, valid, controls


def stress_stepper(shape, n_steps, dev, dense=True):
    """(cfg, state, step(state, t)) for the shipped cfg at a shape on the
    stress stream; dense adds bench.py's dense_stress_config overrides."""
    import torch
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.filter.state import Measurements, SlamState
    from phdslam_tpu_torch.filter.step import slam_step

    cfg = load_config(str(ROOT / "cfg/ackerman_synth.cfg")).replace(
        n_particles=shape["P"], maxFeatures=shape["F"],
        maxMeasurements=shape["M"])
    if dense:
        cfg = cfg.replace(y0=0.0, birthWeight=1e-3, clutterRate=50.0)
    rb, valid, controls = stress_inputs(cfg, n_steps)
    label = np.zeros((cfg.maxMeasurements,), np.int32)
    zs = [Measurements.from_numpy(rb[t], label, valid[t], dev)
          for t in range(n_steps)]
    gen = torch.Generator(device=dev).manual_seed(0)

    def step(state, t):
        return slam_step(state, (float(controls[t, 0]),
                                 float(controls[t, 1])), zs[t],
                         float(cfg.dt), t > 0, cfg, generator=gen)

    return cfg, SlamState.create(cfg, dev), step


def phase_dense(dev, stats, gpu):
    import torch
    from phdslam_tpu_torch.kernels import merge as G
    from phdslam_tpu_torch.kernels import select as S

    t0 = time.perf_counter()
    n = WARMUP + TIMED
    _, state, step = stress_stepper(DENSE, n, dev)
    for t in range(WARMUP):
        state, aux = step(state, t)
    torch.cuda.synchronize()
    with _KernelTimer(S, "select_cuda") as k1, \
            _KernelTimer(G, "merge_cuda") as k2:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for t in range(WARMUP, n):
            state, aux = step(state, t)
        end.record()
        torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / TIMED
    k1_ms, k2_ms = k1.ms() / TIMED, k2.ms() / TIMED
    glue_ms = step_ms - k1_ms - k2_ms
    neff = float(aux.neff)
    live = int((state.map_static.w > 0).sum(1).max())
    log(f"dense step {DENSE['P']}x{DENSE['F']}x{DENSE['M']}: "
        f"{step_ms:.3f} ms/step = pre-update and glue {glue_ms:.3f} + "
        f"select kernel {k1_ms:.3f} + merge kernel {k2_ms:.3f} "
        f"(neff {neff:.4f}, max live map slots {live})")
    # both kernels against their plain versions on the last timed step's
    # own inputs (real pools hold exact weight ties, e.g. births of
    # measurements no feature explains)
    agree_on_last_args(k1, k2, stats, "dense step")
    sel, mer = stats["select"], stats["merge"]
    log(f"dense timing on {gpu}: step {step_ms:.3f} ms; select kernel "
        f"{sel['ms']:.4f} ms vs plain {sel['plain_ms']:.3f} ms; merge kernel "
        f"{mer['ms']:.3f} ms vs plain {mer['plain_ms']:.3f} ms (phase 2 "
        f"inputs)")
    if not np.isfinite(neff) or glue_ms < 0:
        raise RuntimeError(f"dense step: neff {neff}, glue {glue_ms} ms")
    stats["dense_ms_per_step"] = step_ms
    log(f"phase dense: ok ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------- optional: --profile --

def phase_profile(dev):
    """torch.profiler over PROFILED steps of the step at the dense and the
    shipped shape (stress stream), after PROFILE_WARMUP steps. Prints the
    host wall time per step (without the profiler), the device's busy share
    of the profiled window (the union of its kernel and copy intervals) and
    the ops and kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    n = PROFILE_WARMUP + 2 * PROFILED
    for name, shape, dense in (("dense", DENSE, True),
                               ("shipped", SHIPPED, False)):
        _, state, step = stress_stepper(shape, n, dev, dense)
        for t in range(PROFILE_WARMUP):
            state, _ = step(state, t)
        torch.cuda.synchronize()
        t_wall = time.perf_counter()
        for t in range(PROFILE_WARMUP, PROFILE_WARMUP + PROFILED):
            state, _ = step(state, t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_wall) * 1e3 / PROFILED
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for t in range(PROFILE_WARMUP + PROFILED, n):
                state, _ = step(state, t)
            torch.cuda.synchronize()
        events = prof.events()
        on_dev = sorted((e.time_range.start, e.time_range.end)
                        for e in events if e.device_type == DeviceType.CUDA)
        lo = min(e.time_range.start for e in events)
        hi = max(e.time_range.end for e in events)
        busy, reach = 0.0, lo
        for a, b in on_dev:         # union of the device intervals, in us
            busy += max(0.0, b - max(a, reach))
            reach = max(reach, b)
        dims = "x".join(str(shape[k]) for k in "PFM")
        busy_ms = busy / 1e3 / PROFILED
        # the profiler slows the host, so the window overstates the idle
        # share; the device's work is the same with it off
        log(f"profile {name} {dims}: host wall {wall_ms:.3f} ms/step "
            f"(profiler off); device busy {busy_ms:.3f} ms/step = "
            f"{busy_ms / wall_ms:.1%} of that wall, {busy / (hi - lo):.1%} "
            f"of the profiled window ({(hi - lo) / 1e3 / PROFILED:.3f} "
            f"ms/step); {len(on_dev) / PROFILED:.0f} device activities/step")
        # ops that launch device work, and our kernels (launched outside
        # any op): device time of each per step
        rows = [e for e in prof.key_averages() if e.self_device_time_total
                > 0 and (e.device_type == DeviceType.CPU
                         or "_kernel" in e.key and "at::" not in e.key)]
        rows.sort(key=lambda e: -e.self_device_time_total)
        for e in rows[:PROFILE_ROWS]:
            log(f"  {e.self_device_time_total / 1e3 / PROFILED:8.3f} ms/step"
                f"  {e.count / PROFILED:5.1f} calls/step  {e.key[:70]}")
    log(f"phase profile: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------------------------ main --

def main(argv=None):
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the dense and shipped-shape step "
                    "with torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "phdslam_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no phdslam_tpu_torch package beside {__file__};"
              " run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gpu = gpu_line()
    log(gpu)                        # nvidia-smi's name, power.limit as is
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    from phdslam_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _, info = _build.library()
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"phase build: ok ({time.perf_counter() - t0:.1f} s, nvcc "
        f"{info['seconds']:.1f} s, {'built' if info['built'] else 'cached'}"
        f" {info['path']})")

    stats = {}
    phase_select(dev, stats)
    phase_merge(dev, stats)
    phase_main_path(dev, stats)
    phase_dense(dev, stats, gpu)
    if args.profile:
        phase_profile(dev)

    kernels = []
    for name, src, replaces in (
            ("select", "phdslam_tpu_torch/csrc/select.cu",
             "phdslam_tpu/kernels/preupdate_pallas.py:274"),
            ("merge", "phdslam_tpu_torch/csrc/merge.cu",
             "phdslam_tpu/kernels/merge_pallas.py:331")):
        s = stats[name]
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces,
                            launches=stats["launches"][name],
                            max_abs_err=s["max_abs_err"], ms=s["ms"],
                            plain_ms=s["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

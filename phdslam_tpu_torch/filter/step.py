"""One SLAM step of the GM-PHD, CPHD and FastSLAM filters, and a whole-run
loop.

Port of ``phdslam_tpu/filter/step.py``: the PHD filter on the static map or
the dynamic / mixed static + dynamic maps, the CPHD filter (filter_type =
1) and FastSLAM (filter_type = 2) on the static map:

    predict -> [CPHD births] -> update -> weight normalize -> nEff ->
    resample

JAX gates predict, update and resample with ``lax.cond`` on traced values.
Here the first two are known on the host (the runner's schedule and the
numpy measurement mask), so they are Python bools and the device is never
read inside a step; so is the CPHD birth gate (the previous step's
measurement count). The resample trigger lives on the device: the indices
are always computed and ``torch.where(trigger, idx, arange)`` picks them or
the identity before the gather, which gives the ``cond``'s result. With a
mesh the trigger is read once instead (below).

Monte-Carlo runs (``phdslam_tpu/eval/batch.py``'s vmapped path): with
per-run measurements (``z.rb [R, M, 2]``) the state holds R runs of
``n_particles`` blockwise (``filter/runs.py``, ``SlamState.create(...,
n_runs=R)``) and one step advances all R. Every reduction over the
particles (the weight normalisation, nEff, the expected pose, the
resample, the shotgun contraction, the MAP particle of ``log_aux``) is per
run, and the aux values gain a leading [R]. The host gates become per run:
the update runs when any run has a measurement, and a run without one
keeps its pre-update state (``runs.select_runs``); so do the CPHD births.
Run r draws its noise from its own generator in the single run's order,
so it filters the draws it would filter alone.

Particle-axis sharding (``parallel/mesh.py``, JAX's ``pmesh``): with a
``mesh`` the state holds this rank's P/W rows. Everything up to the
normalisation runs on them alone. The normalisation, nEff, the expected
pose, the resample (and its shotgun contraction) and ``log_aux``'s MAP
particle read the gathered [P] weights and poses and compute exactly what
the single process computes. The resample's trigger is read on the host
(``parallel/mesh.py::read_flag``, the step's one read of the device),
since the gather it gates is a collective enqueued from the host: as
under JAX's ``lax.cond``, a step whose resample fires takes the rank's
rows of the gathered state, and one that does not moves no map and keeps
its rows.
Every rank draws the global step's draws and uses its rows of the pose
normals, so a sharded step equals the single-process step bit for bit. A
mesh steps one run: it has no run axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from phdslam_tpu_torch.config import (CPHD_TYPE, DYNAMIC_MODEL,
                                      FASTSLAM_TYPE, MIXED_MODEL,
                                      STATIC_MODEL)
from phdslam_tpu_torch.filter import cphd
from phdslam_tpu_torch.filter.estimate import weighted_pose
from phdslam_tpu_torch.filter.fastslam import fastslam_update
from phdslam_tpu_torch.filter.predict import (noise_dim, predict,
                                              shotgun_expand)
from phdslam_tpu_torch.filter.runs import (normalise, per_particle,
                                           run_view, select_runs)
from phdslam_tpu_torch.filter.state import Measurements, SlamState
from phdslam_tpu_torch.filter.update import phd_update_static, phd_variance
from phdslam_tpu_torch.filter.update4 import (informed_birth_velocity,
                                              phd_update_mixed,
                                              prev_measurement_world)
from phdslam_tpu_torch.ops.resample import neff, stratified_resample_indices
from phdslam_tpu_torch.parallel.mesh import (everywhere, gather_rows,
                                             global_row, read_flag,
                                             unshard_state)


class StepAux(NamedTuple):
    """One step's values; each gains a leading [R] for R runs."""

    expected_pose: torch.Tensor   # [6]
    neff: torch.Tensor            # scalar (normalized)
    resampled: torch.Tensor       # bool
    n_measure: torch.Tensor       # int
    log_lik: torch.Tensor         # logsumexp of the unnormalized weights


class LogAux(NamedTuple):
    """What the state_estimate log needs after a whole-run loop: the MAP
    particle's map and the per-particle quantities (a leading [R] for R
    runs)."""

    map_w: torch.Tensor           # [F]
    map_mx: torch.Tensor
    map_my: torch.Tensor
    map_c00: torch.Tensor
    map_c01: torch.Tensor
    map_c11: torch.Tensor
    dyn_w: torch.Tensor           # [Fd]
    dyn_mean: torch.Tensor        # [4, Fd]
    dyn_cov: torch.Tensor         # [10, Fd]
    log_weights: torch.Tensor     # [P]
    poses: torch.Tensor           # [P, 6]
    resample_idx: torch.Tensor    # [P]
    cardinality: torch.Tensor     # [N+1] MAP particle's; zeros(1) (PHD)


def check_supported(cfg):
    """Raise ValueError for a feature model or merge metric the filter
    does not have."""
    if cfg.featureModel not in (STATIC_MODEL, DYNAMIC_MODEL, MIXED_MODEL):
        raise ValueError(f"feature_model must be 0, 1 or 2, got "
                         f"{cfg.featureModel}")
    if cfg.distanceMetric not in (0, 1):
        raise ValueError(f"distance_metric must be 0 or 1, got "
                         f"{cfg.distanceMetric}")


def draw_noise(cfg, n_predicted: int, device, generator=None,
               dtype=torch.float32):
    """One step's random draws: (pose_normals [sub, n_predicted, d],
    resample_uniforms [n_particles]), d = 2 (Ackerman) or 3 (CV). With a
    list of R generators, R runs: run r draws its n_predicted / R normals
    and n_particles uniforms from generator r, as alone, and the runs'
    draws are concatenated on the particle axis."""
    if isinstance(generator, (list, tuple)):
        per_run = [draw_noise(cfg, n_predicted // len(generator), device, g,
                              dtype) for g in generator]
        return (torch.cat([n for n, _ in per_run], 1),
                torch.cat([u for _, u in per_run]))
    sub = max(int(cfg.subdividePredict), 1)
    normals = torch.randn((sub, n_predicted, noise_dim(cfg)),
                          generator=generator, device=device, dtype=dtype)
    uniforms = torch.rand((cfg.n_particles,), generator=generator,
                          device=device, dtype=dtype)
    return normals, uniforms


def predicted_state(state: SlamState, control, dt: float, do_predict: bool,
                    cfg, noise) -> SlamState:
    """The post-prediction state exactly as ``slam_step`` computes it from
    the same ``noise`` (``draw_noise``'s pair; the pose normals [sub, P *
    nPredictParticles, d] are used): shotgun expansion, then under
    do_predict the sub-stepped pose and dynamic-map prediction and the
    CPHD cardinality convolution. What save_prediction writes and what the
    update consumes."""
    state = shotgun_expand(state, max(int(cfg.nPredictParticles), 1))
    if do_predict:
        sub = max(int(cfg.subdividePredict), 1)
        for i in range(sub):
            state = predict(state, control, noise[0][i], cfg, dt / sub)
        if cfg.filterType == CPHD_TYPE and not cfg.cnPoissonPredict:
            # the carried prior convolved with the birth cardinality
            state = state.replace(cardinality=cphd.cardinality_predict(
                state.cardinality, state.cn_birth))
    return state


def gather_particles(state: SlamState, idx, new_log_w, lineage,
                     mesh=None) -> SlamState:
    """The particles at idx, with resample_idx = lineage (``_lineage``:
    idx, or for R runs each run's own indices). With a mesh, idx,
    new_log_w and lineage are global [P]: the rank takes its slice of each
    and its rows of the gathered state."""
    if mesh is not None:
        state = unshard_state(state, mesh, "resample")
        idx, new_log_w, lineage = (mesh.local(t)
                                   for t in (idx, new_log_w, lineage))
    new = state.map(lambda t: t.index_select(0, idx))
    return new.replace(log_weights=new_log_w, resample_idx=lineage)


def slam_step(state: SlamState, control, z: Measurements, dt: float,
              do_predict: bool, cfg, *, generator=None, noise=None,
              with_variance: bool = False, z_prev: Measurements = None,
              mesh=None, layout_runs=None):
    """One SLAM time step; returns (state', StepAux).

    control     (v_encoder, alpha), floats or 0-d tensors; per run [R]
                tensors
    z           padded Measurements; ``z.count`` (host int) gates the update.
                Per-run sets (``z.rb [R, M, 2]``) step R runs at once: the
                state holds R blocks of n_particles, every aux value gains a
                leading [R], and ``generator`` is a list of R generators
    dt          host float
    do_predict  host bool: the first step skips prediction
    noise       (pose_normals [sub, P * nPredictParticles, d],
                resample_uniforms [P]) to replay given draws (R runs: the
                runs' draws concatenated); otherwise the draws come from
                ``generator`` on the state's device
    z_prev      the previous step's Measurements: under birthVelocityInit
                the dynamic births take their velocity from them, and the
                CPHD births come from them (None: no births)
    mesh        a ``parallel.mesh.ParticleMesh``: the state holds the
                rank's P/W rows; noise (given or drawn) is the global
                step's; the aux values are global
    layout_runs R runs of this many: each per-run reduction rounds as
                among all of them (``ops/resample.py``; the island step
                across ranks passes its n islands)
    """
    check_supported(cfg)
    is_cphd = cfg.filterType == CPHD_TYPE
    n_runs = z.n_runs
    every, own = everywhere(mesh, "step")
    n_ranks = 1 if mesh is None else mesh.world_size
    if mesh is not None and n_runs is not None:
        raise ValueError("a sharded step (mesh) has no run axis: per-run "
                         "measurement sets need the single process")
    n_target = cfg.n_particles * (n_runs or 1)
    n_copies = max(int(cfg.nPredictParticles), 1)
    dtype = state.log_weights.dtype
    dev = state.device
    mixed = cfg.featureModel in (DYNAMIC_MODEL, MIXED_MODEL)
    if n_runs is not None and state.n_particles \
            != n_runs * cfg.n_particles:
        raise ValueError(f"{n_runs} measurement sets need {n_runs} x "
                         f"{cfg.n_particles} particles, the state holds "
                         f"{state.n_particles}")
    if noise is None:
        noise = draw_noise(cfg, state.n_particles * n_ranks * n_copies, dev,
                           generator, dtype)
    uniforms = noise[1]
    if mesh is not None:
        noise = (mesh.local(noise[0], 1), uniforms)

    # ---- informed 4-D birth anchors: the previous measurements in the
    # world frame at the poses before this step's prediction ----
    zw_prev = None
    if mixed and cfg.birthVelocityInit and z_prev is not None:
        zw_prev = prev_measurement_world(state.pose, z_prev.rb, z_prev.valid)
        if n_copies > 1:        # the anchors follow the shotgun copies
            zw_prev = torch.repeat_interleave(zw_prev, n_copies, dim=0)

    # ---- prediction (shotgun expansion, then sub-stepped pose and
    # dynamic map) ----
    state = predicted_state(state, control, dt, do_predict, cfg, noise)

    # ---- CPHD births from the previous measurements ----
    if is_cphd:
        consts = cphd.make_constants(cfg, dev)
        if z_prev is not None and z_prev.any_run:
            new_map, cn_birth = cphd.add_births(
                state.map_static, state.pose, z_prev.rb, z_prev.valid, cfg,
                consts)
            born = state.replace(map_static=new_map, cn_birth=cn_birth)
            state = born if z_prev.every_run \
                else select_runs(z_prev.run_mask(), born, state)

    # ---- measurement update ----
    n_measure = z.valid.sum(-1)
    # the runs with a measurement, where some run has none
    has_z = z.run_mask() if z.any_run and not z.every_run else None
    before = state
    if z.any_run and cfg.filterType == FASTSLAM_TYPE:
        gm_out, dw = fastslam_update(state.pose, state.map_static, z.rb,
                                     z.valid, cfg)
        lw, log_lik = normalise(every(state.log_weights + dw), n_runs,
                                 layout_runs)
        lw = own(lw)
        state = state.replace(map_static=gm_out, log_weights=lw)
    elif z.any_run and is_cphd:
        map_out, cn_update, dw = cphd.cphd_update(
            state.pose, state.map_static, state.cardinality, z.rb, z.label,
            z.valid, cfg, consts)
        lw, log_lik = normalise(every(state.log_weights + dw), n_runs,
                                 layout_runs)
        lw = own(lw)
        state = state.replace(map_static=map_out, log_weights=lw,
                              cardinality=cn_update)
    elif z.any_run and mixed:
        birth_vel = None
        if zw_prev is not None:
            birth_vel = informed_birth_velocity(state.pose, z.rb, z.valid,
                                                zw_prev, z_prev.valid, dt,
                                                cfg)
        gm2, gm4, dw = phd_update_mixed(state.pose, state.map_static,
                                        state.map_dynamic, z.rb, z.label,
                                        z.valid, cfg, birth_vel=birth_vel)
        lw, log_lik = normalise(every(state.log_weights + dw), n_runs,
                                 layout_runs)
        lw = own(lw)
        state = state.replace(map_static=gm2, map_dynamic=gm4,
                              log_weights=lw)
    elif z.any_run:
        res = phd_update_static(state.pose, state.map_static, z.rb, z.label,
                                z.valid, cfg)
        lw, log_lik = normalise(
            every(state.log_weights + res.log_weight_delta), n_runs,
            layout_runs)
        lw = own(lw)
        var = phd_variance(res, z.valid) if with_variance \
            else state.variances
        state = state.replace(map_static=res.map_out, log_weights=lw,
                              variances=var)
    else:
        log_lik = torch.zeros(() if n_runs is None else (n_runs,),
                              dtype=dtype, device=dev)
    if has_z is not None:
        # the runs without a measurement keep their pre-update state
        state = select_runs(has_z, state, before)
        log_lik = torch.where(has_z, log_lik, 0.0)

    lw_all = every(state.log_weights)
    exp_pose = weighted_pose(lw_all, every(state.pose), n_runs, layout_runs)
    n_eff = neff(lw_all, n_runs, layout_runs)
    if cfg.debug:
        lw_runs = run_view(lw_all, n_runs)
        print(f"[debug] log_lik={log_lik.tolist()} neff={n_eff.tolist()}"
              f" lw[min,max]=[{lw_runs.amin(-1).tolist()},"
              f"{lw_runs.amax(-1).tolist()}] "
              f"card0={float(state.map_static.w[0].sum()):.2f}")

    # ---- resampling ----
    run_shape = () if n_runs is None else (n_runs,)
    arange = torch.arange(n_target, dtype=torch.int32, device=dev)
    uniform_lw = torch.full((n_target,), -math.log(float(cfg.n_particles)),
                            dtype=dtype, device=dev)
    n_in = state.n_particles * n_ranks
    if n_in != n_target:
        # shotgun-expanded step: always contract back to n_particles
        idx = stratified_resample_indices(lw_all, uniforms,
                                          cfg.n_particles, n_runs,
                                          layout_runs)
        state = gather_particles(state, idx, uniform_lw,
                                 _lineage(idx, n_runs, n_in), mesh)
        resampled = torch.ones(run_shape, dtype=torch.bool, device=dev)
    elif z.any_run:
        trigger = n_eff <= cfg.resampleThresh
        if has_z is not None:
            trigger = trigger & has_z
        if mesh is None:
            idx = stratified_resample_indices(lw_all, uniforms,
                                              cfg.n_particles, n_runs,
                                              layout_runs)
            trig = trigger if n_runs is None \
                else per_particle(trigger, n_target)
            idx = torch.where(trig, idx, arange)
            state = gather_particles(
                state, idx, torch.where(trig, uniform_lw, lw_all),
                _lineage(idx, n_runs, n_in))
        elif read_flag(trigger, mesh, "resample"):
            idx = stratified_resample_indices(lw_all, uniforms,
                                              cfg.n_particles)
            state = gather_particles(state, idx, uniform_lw, idx, mesh)
        else:
            # the torch.where path's bits with the identity: the rank's
            # rows, weights and lineage as they are; no map moves
            state = state.replace(log_weights=own(lw_all),
                                  resample_idx=own(arange))
        resampled = trigger
    else:
        state = state.replace(
            resample_idx=own(_lineage(arange, n_runs, n_in)))
        resampled = torch.zeros(run_shape, dtype=torch.bool, device=dev)

    return state, StepAux(expected_pose=exp_pose, neff=n_eff,
                          resampled=resampled, n_measure=n_measure,
                          log_lik=log_lik)


def _lineage(idx, n_runs, n_in: int):
    """Each run's own resample indices: idx less r n_in / R in run r's
    block (idx itself for one run)."""
    if n_runs is None:
        return idx
    per = n_in // n_runs
    off = torch.arange(n_runs, dtype=idx.dtype, device=idx.device) * per
    return (idx.reshape(n_runs, -1) - off[:, None]).reshape(-1)


def log_aux(state: SlamState, n_runs=None, mesh=None) -> LogAux:
    """The MAP particle's maps and the per-particle values; with
    ``n_runs`` each run's, on a leading [R]; with a mesh the global ones
    on every rank (the MAP particle's rows from the rank that holds it,
    the first of equal weights as in the single process)."""
    if mesh is not None:
        gather = lambda t: gather_rows(t, mesh)
        idx = torch.argmax(gather(state.log_weights))
        row = lambda t: global_row(t, idx, mesh)
        each = gather
    elif n_runs is None:
        idx = torch.argmax(state.log_weights).reshape(1)
        row = lambda t: t.index_select(0, idx)[0]
        each = lambda t: t
    else:
        lw = state.log_weights.reshape(n_runs, -1)
        idx = torch.argmax(lw, 1) + torch.arange(
            n_runs, device=lw.device) * lw.shape[1]
        row = lambda t: t.index_select(0, idx)
        each = lambda t: run_view(t, n_runs)
    ms, md = state.map_static, state.map_dynamic
    if state.cardinality is not None:
        cn = row(state.cardinality)
    else:
        cn = state.log_weights.new_zeros(
            (1,) if n_runs is None else (n_runs, 1))
    return LogAux(
        map_w=row(ms.w), map_mx=row(ms.mx), map_my=row(ms.my),
        map_c00=row(ms.c00), map_c01=row(ms.c01), map_c11=row(ms.c11),
        dyn_w=row(md.w), dyn_mean=row(md.mean_channels),
        dyn_cov=row(md.cov_channels), log_weights=each(state.log_weights),
        poses=each(state.pose), resample_idx=each(state.resample_idx),
        cardinality=cn)


def run_scan(state: SlamState, controls, zs, dts, cfg, *, generator=None,
             noises: Optional[list] = None, with_log_state: bool = False,
             with_variance: bool = False, mesh=None):
    """Run ``slam_step`` over a whole dataset without reading the device
    (with a mesh, once a step: the resample's trigger).

    controls [T, 2] (host); zs: T Measurements on the state's device;
    dts [T] (host). Step 0 skips prediction. Each step gets the previous
    step's measurements as ``z_prev``, step 0 an empty set. Returns
    (final_state, stacked StepAux), or (final_state, (stacked StepAux,
    stacked LogAux)) with ``with_log_state``. R runs at once: per-run
    measurement sets, controls [T, R, 2] (copied to the device once),
    ``generator`` a list of R, and the stacked values [T, R, ...]."""
    auxs, logs = [], []
    n_runs = zs[0].n_runs
    dev = zs[0].rb.device
    z_prev = Measurements.empty(zs[0].rb.shape[-2], dev, n_runs)
    if n_runs is not None:
        ctl = torch.as_tensor(np.asarray(controls, np.float32), device=dev)
    for t, z in enumerate(zs):
        if n_runs is None:
            control = (float(controls[t][0]), float(controls[t][1]))
        else:
            control = (ctl[t, :, 0], ctl[t, :, 1])
        state, aux = slam_step(
            state, control, z, float(dts[t]), t > 0, cfg,
            generator=generator,
            noise=None if noises is None else noises[t],
            with_variance=with_variance, z_prev=z_prev, mesh=mesh)
        z_prev = z
        auxs.append(aux)
        if with_log_state:
            logs.append(log_aux(state, n_runs, mesh))
    stacked = StepAux(*(torch.stack(f) for f in zip(*auxs)))
    if with_log_state:
        return state, (stacked, LogAux(*(torch.stack(f) for f in zip(*logs))))
    return state, stacked

"""One SLAM step of the GM-PHD and CPHD filters, and a whole-run loop.

Port of ``phdslam_tpu/filter/step.py``: the PHD filter on the static map or
the dynamic / mixed static + dynamic maps, and the CPHD filter
(filter_type = 1) on the static map:

    predict -> [CPHD births] -> update -> weight normalize -> nEff ->
    resample

JAX gates predict, update and resample with ``lax.cond`` on traced values.
Here the first two are known on the host (the runner's schedule and the
numpy measurement mask), so they are Python bools and the device is never
read inside a step; so is the CPHD birth gate (the previous step's
measurement count). The resample trigger lives on the device: the indices
are always computed and ``torch.where(trigger, idx, arange)`` picks them or
the identity before the gather, which gives the ``cond``'s result.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from phdslam_tpu_torch.config import (CPHD_TYPE, DYNAMIC_MODEL,
                                      FASTSLAM_TYPE, MIXED_MODEL,
                                      STATIC_MODEL)
from phdslam_tpu_torch.filter import cphd
from phdslam_tpu_torch.filter.estimate import expected_pose
from phdslam_tpu_torch.filter.predict import (noise_dim, predict,
                                              shotgun_expand)
from phdslam_tpu_torch.filter.state import Measurements, SlamState
from phdslam_tpu_torch.filter.update import phd_update_static, phd_variance
from phdslam_tpu_torch.filter.update4 import (informed_birth_velocity,
                                              phd_update_mixed,
                                              prev_measurement_world)
from phdslam_tpu_torch.ops.resample import neff, stratified_resample_indices


class StepAux(NamedTuple):
    expected_pose: torch.Tensor   # [6]
    neff: torch.Tensor            # scalar (normalized)
    resampled: torch.Tensor       # bool
    n_measure: torch.Tensor       # int
    log_lik: torch.Tensor         # logsumexp of the unnormalized weights


class LogAux(NamedTuple):
    """What the state_estimate log needs after a whole-run loop: the MAP
    particle's map and the per-particle quantities."""

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
    """Raise NotImplementedError for a configuration the port does not
    cover yet, naming the ROADMAP item that ports it."""
    if cfg.filterType == FASTSLAM_TYPE:
        raise NotImplementedError(
            "filter_type = 2 (FastSLAM) is ROADMAP Queue 1 item 11")
    if cfg.featureModel not in (STATIC_MODEL, DYNAMIC_MODEL, MIXED_MODEL):
        raise ValueError(f"feature_model must be 0, 1 or 2, got "
                         f"{cfg.featureModel}")
    if cfg.distanceMetric not in (0, 1):
        raise ValueError(f"distance_metric must be 0 or 1, got "
                         f"{cfg.distanceMetric}")


def draw_noise(cfg, n_predicted: int, device, generator=None,
               dtype=torch.float32):
    """One step's random draws: (pose_normals [sub, n_predicted, d],
    resample_uniforms [n_particles]), d = 2 (Ackerman) or 3 (CV)."""
    sub = max(int(cfg.subdividePredict), 1)
    normals = torch.randn((sub, n_predicted, noise_dim(cfg)),
                          generator=generator, device=device, dtype=dtype)
    uniforms = torch.rand((cfg.n_particles,), generator=generator,
                          device=device, dtype=dtype)
    return normals, uniforms


def gather_particles(state: SlamState, idx, new_log_w) -> SlamState:
    new = state.map(lambda t: t.index_select(0, idx))
    return new.replace(log_weights=new_log_w, resample_idx=idx)


def slam_step(state: SlamState, control, z: Measurements, dt: float,
              do_predict: bool, cfg, *, generator=None, noise=None,
              with_variance: bool = False, z_prev: Measurements = None):
    """One SLAM time step; returns (state', StepAux).

    control     (v_encoder, alpha), floats or 0-d tensors
    z           padded Measurements; ``z.count`` (host int) gates the update
    dt          host float
    do_predict  host bool: the first step skips prediction
    noise       (pose_normals [sub, P * nPredictParticles, d],
                resample_uniforms [P]) to replay given draws; otherwise the
                draws come from ``generator`` on the state's device
    z_prev      the previous step's Measurements: under birthVelocityInit
                the dynamic births take their velocity from them, and the
                CPHD births come from them (None: no births)
    """
    check_supported(cfg)
    is_cphd = cfg.filterType == CPHD_TYPE
    n_target = cfg.n_particles
    n_copies = max(int(cfg.nPredictParticles), 1)
    sub = max(int(cfg.subdividePredict), 1)
    dtype = state.log_weights.dtype
    dev = state.device
    mixed = cfg.featureModel in (DYNAMIC_MODEL, MIXED_MODEL)
    if noise is None:
        noise = draw_noise(cfg, state.n_particles * n_copies, dev, generator,
                           dtype)
    normals, uniforms = noise

    # ---- informed 4-D birth anchors: the previous measurements in the
    # world frame at the poses before this step's prediction ----
    zw_prev = None
    if mixed and cfg.birthVelocityInit and z_prev is not None:
        zw_prev = prev_measurement_world(state.pose, z_prev.rb, z_prev.valid)
        if n_copies > 1:        # the anchors follow the shotgun copies
            zw_prev = torch.repeat_interleave(zw_prev, n_copies, dim=0)

    # ---- prediction (shotgun expansion, then sub-stepped pose and
    # dynamic map) ----
    state = shotgun_expand(state, n_copies)
    if do_predict:
        for i in range(sub):
            state = predict(state, control, normals[i], cfg, dt / sub)
        if is_cphd and not cfg.cnPoissonPredict:
            # the carried prior convolved with the birth cardinality
            state = state.replace(cardinality=cphd.cardinality_predict(
                state.cardinality, state.cn_birth))

    # ---- CPHD births from the previous measurements ----
    if is_cphd:
        consts = cphd.make_constants(cfg, dev)
        if z_prev is not None and z_prev.count > 0:
            new_map, cn_birth = cphd.add_births(
                state.map_static, state.pose, z_prev.rb, z_prev.valid, cfg,
                consts)
            state = state.replace(map_static=new_map, cn_birth=cn_birth)

    # ---- measurement update ----
    n_measure = z.valid.sum()
    if z.count > 0 and is_cphd:
        map_out, cn_update, dw = cphd.cphd_update(
            state.pose, state.map_static, state.cardinality, z.rb, z.label,
            z.valid, cfg, consts)
        lw = state.log_weights + dw
        log_lik = torch.logsumexp(lw, 0)
        state = state.replace(map_static=map_out, log_weights=lw - log_lik,
                              cardinality=cn_update)
    elif z.count > 0 and mixed:
        birth_vel = None
        if zw_prev is not None:
            birth_vel = informed_birth_velocity(state.pose, z.rb, z.valid,
                                                zw_prev, z_prev.valid, dt,
                                                cfg)
        gm2, gm4, dw = phd_update_mixed(state.pose, state.map_static,
                                        state.map_dynamic, z.rb, z.label,
                                        z.valid, cfg, birth_vel=birth_vel)
        lw = state.log_weights + dw
        log_lik = torch.logsumexp(lw, 0)
        state = state.replace(map_static=gm2, map_dynamic=gm4,
                              log_weights=lw - log_lik)
    elif z.count > 0:
        res = phd_update_static(state.pose, state.map_static, z.rb, z.label,
                                z.valid, cfg)
        lw = state.log_weights + res.log_weight_delta
        log_lik = torch.logsumexp(lw, 0)
        lw = lw - log_lik
        var = phd_variance(res, z.valid) if with_variance \
            else state.variances
        state = state.replace(map_static=res.map_out, log_weights=lw,
                              variances=var)
    else:
        log_lik = torch.zeros((), dtype=dtype, device=dev)

    exp_pose = expected_pose(state)
    n_eff = neff(state.log_weights)
    if cfg.debug:
        print(f"[debug] log_lik={float(log_lik):.6f} neff={float(n_eff):.4f}"
              f" lw[min,max]=[{float(state.log_weights.min()):.4f},"
              f"{float(state.log_weights.max()):.4f}] "
              f"card0={float(state.map_static.w[0].sum()):.2f}")

    # ---- resampling ----
    arange = torch.arange(n_target, dtype=torch.int32, device=dev)
    uniform_lw = torch.full((n_target,), -math.log(float(n_target)),
                            dtype=dtype, device=dev)
    if state.n_particles != n_target:
        # shotgun-expanded step: always contract back to n_particles
        idx = stratified_resample_indices(state.log_weights, uniforms,
                                          n_target)
        state = gather_particles(state, idx, uniform_lw)
        resampled = torch.ones((), dtype=torch.bool, device=dev)
    elif z.count > 0:
        trigger = n_eff <= cfg.resampleThresh
        idx = stratified_resample_indices(state.log_weights, uniforms,
                                          n_target)
        idx = torch.where(trigger, idx, arange)
        state = gather_particles(
            state, idx, torch.where(trigger, uniform_lw, state.log_weights))
        resampled = trigger
    else:
        state = state.replace(resample_idx=arange)
        resampled = torch.zeros((), dtype=torch.bool, device=dev)

    return state, StepAux(expected_pose=exp_pose, neff=n_eff,
                          resampled=resampled, n_measure=n_measure,
                          log_lik=log_lik)


def log_aux(state: SlamState) -> LogAux:
    idx = torch.argmax(state.log_weights).reshape(1)
    row = lambda t: t.index_select(0, idx)[0]
    ms, md = state.map_static, state.map_dynamic
    cn = (state.log_weights.new_zeros((1,)) if state.cardinality is None
          else row(state.cardinality))
    return LogAux(
        map_w=row(ms.w), map_mx=row(ms.mx), map_my=row(ms.my),
        map_c00=row(ms.c00), map_c01=row(ms.c01), map_c11=row(ms.c11),
        dyn_w=row(md.w), dyn_mean=row(md.mean_channels),
        dyn_cov=row(md.cov_channels), log_weights=state.log_weights,
        poses=state.pose, resample_idx=state.resample_idx,
        cardinality=cn)


def run_scan(state: SlamState, controls, zs, dts, cfg, *, generator=None,
             noises: Optional[list] = None, with_log_state: bool = False,
             with_variance: bool = False):
    """Run ``slam_step`` over a whole dataset without reading the device.

    controls [T, 2] (host); zs: T Measurements on the state's device;
    dts [T] (host). Step 0 skips prediction. Each step gets the previous
    step's measurements as ``z_prev``, step 0 an empty set. Returns
    (final_state, stacked StepAux), or (final_state, (stacked StepAux,
    stacked LogAux)) with ``with_log_state``."""
    auxs, logs = [], []
    z_prev = Measurements.empty(zs[0].rb.shape[0], zs[0].rb.device)
    for t, z in enumerate(zs):
        state, aux = slam_step(
            state, (float(controls[t][0]), float(controls[t][1])), z,
            float(dts[t]), t > 0, cfg, generator=generator,
            noise=None if noises is None else noises[t],
            with_variance=with_variance, z_prev=z_prev)
        z_prev = z
        auxs.append(aux)
        if with_log_state:
            logs.append(log_aux(state))
    stacked = StepAux(*(torch.stack(f) for f in zip(*auxs)))
    if with_log_state:
        return state, (stacked, LogAux(*(torch.stack(f) for f in zip(*logs))))
    return state, stacked

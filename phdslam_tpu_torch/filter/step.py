"""One SLAM step on the static GM-PHD path, and a whole-run loop.

Port of ``phdslam_tpu/filter/step.py`` (PHD static branch):

    predict -> PHD update -> weight normalize -> nEff -> resample

JAX gates predict, update and resample with ``lax.cond`` on traced values.
Here the first two are known on the host (the runner's schedule and the
numpy measurement mask), so they are Python bools and the device is never
read inside a step. The resample trigger lives on the device: the indices
are always computed and ``torch.where(trigger, idx, arange)`` picks them or
the identity before the gather, which gives the ``cond``'s result.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from phdslam_tpu_torch._shared import CPHD_TYPE, FASTSLAM_TYPE
from phdslam_tpu_torch.filter.estimate import expected_pose
from phdslam_tpu_torch.filter.predict import (noise_dim, predict,
                                              shotgun_expand)
from phdslam_tpu_torch.filter.state import Measurements, SlamState
from phdslam_tpu_torch.filter.update import phd_update_static, phd_variance
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
    cardinality: torch.Tensor     # zeros(1) on the PHD path


def check_supported(cfg):
    """Raise NotImplementedError for a configuration the static slice does
    not cover, naming the ROADMAP item that ports it."""
    if cfg.filterType == CPHD_TYPE:
        raise NotImplementedError(
            "filter_type = 1 (CPHD) is ROADMAP Queue 1 item 9")
    if cfg.filterType == FASTSLAM_TYPE:
        raise NotImplementedError(
            "filter_type = 2 (FastSLAM) is ROADMAP Queue 1 item 11")
    if cfg.featureModel != 0:
        raise NotImplementedError(
            f"feature_model = {cfg.featureModel} (dynamic / mixed map) is "
            "ROADMAP Queue 1 item 10")
    if cfg.selectByIndex:
        raise NotImplementedError(
            "select_by_index needs fused_update_select_by_index, the next "
            "kernel in ROADMAP Queue 2")
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
              with_variance: bool = False):
    """One SLAM time step; returns (state', StepAux).

    control     (v_encoder, alpha), floats or 0-d tensors
    z           padded Measurements; ``z.count`` (host int) gates the update
    do_predict  host bool: the first step skips prediction
    noise       (pose_normals [sub, P * nPredictParticles, d],
                resample_uniforms [P]) to replay given draws; otherwise the
                draws come from ``generator`` on the state's device
    """
    check_supported(cfg)
    n_target = cfg.n_particles
    n_copies = max(int(cfg.nPredictParticles), 1)
    sub = max(int(cfg.subdividePredict), 1)
    dtype = state.log_weights.dtype
    dev = state.device
    if noise is None:
        noise = draw_noise(cfg, state.n_particles * n_copies, dev, generator,
                           dtype)
    normals, uniforms = noise

    # ---- prediction (shotgun expansion, then sub-stepped pose) ----
    state = shotgun_expand(state, n_copies)
    if do_predict:
        for i in range(sub):
            state = predict(state, control, normals[i], cfg, dt / sub)

    # ---- measurement update ----
    n_measure = z.valid.sum()
    if z.count > 0:
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
    return LogAux(
        map_w=row(ms.w), map_mx=row(ms.mx), map_my=row(ms.my),
        map_c00=row(ms.c00), map_c01=row(ms.c01), map_c11=row(ms.c11),
        dyn_w=row(md.w), dyn_mean=row(md.mean_channels),
        dyn_cov=row(md.cov_channels), log_weights=state.log_weights,
        poses=state.pose, resample_idx=state.resample_idx,
        cardinality=state.log_weights.new_zeros((1,)))


def run_scan(state: SlamState, controls, zs, dts, cfg, *, generator=None,
             noises: Optional[list] = None, with_log_state: bool = False,
             with_variance: bool = False):
    """Run ``slam_step`` over a whole dataset without reading the device.

    controls [T, 2] (host); zs: T Measurements on the state's device;
    dts [T] (host). Step 0 skips prediction. Returns (final_state, stacked
    StepAux), or (final_state, (stacked StepAux, stacked LogAux)) with
    ``with_log_state``."""
    auxs, logs = [], []
    for t, z in enumerate(zs):
        state, aux = slam_step(
            state, (float(controls[t][0]), float(controls[t][1])), z,
            float(dts[t]), t > 0, cfg, generator=generator,
            noise=None if noises is None else noises[t],
            with_variance=with_variance)
        auxs.append(aux)
        if with_log_state:
            logs.append(log_aux(state))
    stacked = StepAux(*(torch.stack(f) for f in zip(*auxs)))
    if with_log_state:
        return state, (stacked, LogAux(*(torch.stack(f) for f in zip(*logs))))
    return state, stacked

"""Prediction (``phdslam_tpu/filter/predict.py``): pose propagation,
particle shotgunning and, under the dynamic and mixed feature models, the
constant-velocity prediction of the dynamic map. The static map needs no
prediction."""

from __future__ import annotations

import math

import torch

from phdslam_tpu_torch.config import (ACKERMAN_MOTION, CV_MOTION,
                                      DYNAMIC_MODEL, MIXED_MODEL)
from phdslam_tpu_torch.filter.runs import per_particle
from phdslam_tpu_torch.filter.state import SlamState
from phdslam_tpu_torch.filter.update4 import cv_predict4, jump_markov_scales
from phdslam_tpu_torch.models.motion import ackerman_predict, cv_predict
from phdslam_tpu_torch.ops.linalg import device_row


def noise_dim(cfg) -> int:
    """Width of one particle's standard-normal pose noise draw."""
    if cfg.motionType == ACKERMAN_MOTION:
        return 2
    if cfg.motionType == CV_MOTION:
        return 3
    raise ValueError(f"unknown motionType {cfg.motionType}")


def shotgun_expand(state: SlamState, n_copies: int) -> SlamState:
    """Repeat each particle n_copies times, lowering its log weight by
    log(n_copies); resample_idx repeats with it."""
    if n_copies <= 1:
        return state
    new = state.map(lambda t: torch.repeat_interleave(t, n_copies, dim=0))
    return new.replace(log_weights=new.log_weights - math.log(n_copies))


def predict_pose(pose, control, std_normal_noise, cfg, dt):
    """One pose sub-step over all particles. std_normal_noise is N(0, 1),
    [P, 2] for Ackerman or [P, 3] for CV, and is scaled here as the
    reference does: Ackerman by (stdEncoder, stdAlpha), CV by three times
    the configured acceleration sigmas."""
    if cfg.motionType == ACKERMAN_MOTION:
        scale = device_row((cfg.stdEncoder, cfg.stdAlpha), pose)
        return ackerman_predict(pose, control, std_normal_noise * scale, cfg,
                                dt)
    if cfg.motionType == CV_MOTION:
        scale = device_row((3.0 * cfg.ax, 3.0 * cfg.ay, 3.0 * cfg.ayaw),
                           pose)
        return cv_predict(pose, std_normal_noise * scale, dt)
    raise ValueError(f"unknown motionType {cfg.motionType}")


def predict(state: SlamState, control, std_normal_noise, cfg,
            dt) -> SlamState:
    """One prediction sub-step: the poses, then the dynamic map (survival
    and jump-Markov weight factors, constant-velocity motion). control:
    (v_encoder, alpha), floats or 0-d tensors, or per run [R] tensors of R
    runs blockwise on the particle axis (``filter/runs.py``), or [P]."""
    control = tuple(per_particle(c, state.n_particles)
                    if torch.is_tensor(c) and c.dim() == 1 else c
                    for c in control)
    state = state.replace(
        pose=predict_pose(state.pose, control, std_normal_noise, cfg, dt))
    if cfg.featureModel in (DYNAMIC_MODEL, MIXED_MODEL) \
            and state.map_dynamic.w.shape[-1] > 0:
        scale, _jump_w = jump_markov_scales(state.map_dynamic, cfg)
        state = state.replace(map_dynamic=cv_predict4(
            state.map_dynamic, cfg, dt, w_scale=scale))
    return state

"""Prediction (``phdslam_tpu/filter/predict.py``): pose propagation and
particle shotgunning. The static feature model needs no map prediction."""

from __future__ import annotations

import math

import torch

from phdslam_tpu_torch._shared import ACKERMAN_MOTION, CV_MOTION
from phdslam_tpu_torch.filter.state import SlamState
from phdslam_tpu_torch.models.motion import ackerman_predict, cv_predict


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
        scale = pose.new_tensor([cfg.stdEncoder, cfg.stdAlpha])
        return ackerman_predict(pose, control, std_normal_noise * scale, cfg,
                                dt)
    if cfg.motionType == CV_MOTION:
        scale = pose.new_tensor([3.0 * cfg.ax, 3.0 * cfg.ay, 3.0 * cfg.ayaw])
        return cv_predict(pose, std_normal_noise * scale, dt)
    raise ValueError(f"unknown motionType {cfg.motionType}")


def predict(state: SlamState, control, std_normal_noise, cfg,
            dt) -> SlamState:
    """Pose prediction of the static branch (one sub-step)."""
    return state.replace(
        pose=predict_pose(state.pose, control, std_normal_noise, cfg, dt))

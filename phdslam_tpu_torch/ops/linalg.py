"""Elementwise helpers of ``phdslam_tpu/ops/linalg.py``."""

from __future__ import annotations

import math

import torch


def safe_log(x: torch.Tensor) -> torch.Tensor:
    """log(x) for x > 0, LOG0 otherwise: the lowest finite value of the
    dtype (-FLT_MAX in float32, where the config's LOG0 literal rounds to
    it)."""
    return torch.where(x > 0, torch.log(torch.clamp(x, min=1e-38)),
                       torch.finfo(x.dtype).min)


def logistic(x, lower, upper, beta, tau):
    """Generalized logistic, (upper - lower) / (1 + exp(-beta (x - tau)))."""
    return (upper - lower) / (1.0 + torch.exp(-beta * (x - tau)))


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi] with the reference's fmod-then-fold rule."""
    two_pi = 2.0 * math.pi
    r = torch.fmod(a, two_pi)
    r = torch.where(r > math.pi, r - two_pi, r)
    return torch.where(r < -math.pi, r + two_pi, r)

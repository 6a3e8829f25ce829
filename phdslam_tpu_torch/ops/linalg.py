"""Elementwise helpers of ``phdslam_tpu/ops/linalg.py``, and the channelwise
4x4 Cholesky form of ``phdslam_tpu/filter/update4.py::chol4_solve_sq``."""

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


def chol4_quad(a, d, eps: float = 1e-12):
    """||L^-1 d||^2 with L the Cholesky factor of the symmetric 4x4 whose
    channels a are listed in the S4 order (00, 01, 02, 03, 11, 12, 13, 22,
    23, 33), for the vector channels d (4): the Mahalanobis quadratic form,
    factored channel by channel with eps under each square root."""
    l00 = torch.sqrt(torch.clamp(a[0], min=eps))
    l10 = a[1] / l00
    l20 = a[2] / l00
    l30 = a[3] / l00
    l11 = torch.sqrt(torch.clamp(a[4] - l10 * l10, min=eps))
    l21 = (a[5] - l20 * l10) / l11
    l31 = (a[6] - l30 * l10) / l11
    l22 = torch.sqrt(torch.clamp(a[7] - l20 * l20 - l21 * l21, min=eps))
    l32 = (a[8] - l30 * l20 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(a[9] - l30 * l30 - l31 * l31 - l32 * l32,
                                 min=eps))
    y0 = d[0] / l00
    y1 = (d[1] - l10 * y0) / l11
    y2 = (d[2] - l20 * y0 - l21 * y1) / l22
    y3 = (d[3] - l30 * y0 - l31 * y1 - l32 * y2) / l33
    return y0 * y0 + y1 * y1 + y2 * y2 + y3 * y3

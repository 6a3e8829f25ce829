"""Range-bearing measurement model (``phdslam_tpu/models/measurement.py``)."""

from __future__ import annotations

import torch

from phdslam_tpu_torch.ops.linalg import wrap_angle


def predict_measurement(pose, feature_xy):
    """h(pose, feature) -> (range, bearing, dx, dy, r2); broadcasting."""
    dx = feature_xy[..., 0] - pose[..., 0]
    dy = feature_xy[..., 1] - pose[..., 1]
    r2 = dx * dx + dy * dy
    r = torch.sqrt(r2)
    bearing = wrap_angle(torch.atan2(dy, dx) - pose[..., 2])
    return r, bearing, dx, dy, r2


def measurement_jacobian(dx, dy, r, r2):
    """Jacobian of (range, bearing) with respect to the feature's (x, y):
    [..., 2, 2], rows (dr/dx, dr/dy) and (db/dx, db/dy)."""
    row_r = torch.stack([dx / r, dy / r], dim=-1)
    row_b = torch.stack([-dy / r2, dx / r2], dim=-1)
    return torch.stack([row_r, row_b], dim=-2)


def detection_probability(r, bearing, cfg):
    """pd inside the field of view (r <= maxRange, |bearing| <=
    maxBearing), 0 outside; no minRange test, as in the reference."""
    inside = (r <= cfg.maxRange) & (bearing.abs() <= cfg.maxBearing)
    return torch.where(inside, cfg.pd, 0.0).to(r.dtype)


def range_class(r, bearing, cfg):
    """1 = in range, 2 = nearly in range (0.8 minRange .. 1.2 maxRange,
    1.2 maxBearing), 0 = out of range; int32."""
    in_r = ((r >= cfg.minRange) & (r <= cfg.maxRange)
            & (bearing.abs() <= cfg.maxBearing))
    near = ((r >= 0.8 * cfg.minRange) & (r <= 1.2 * cfg.maxRange)
            & (bearing.abs() <= 1.2 * cfg.maxBearing))
    one = torch.ones_like(r, dtype=torch.int32)
    return torch.where(in_r, one, torch.where(near, 2 * one, 0 * one))


def birth_gaussian(pose, z_rb, cfg):
    """Inverse-measurement birth Gaussian: (mean [..., 2], cov [..., 2, 2]).
    The Jacobian columns are (cos t, sin t) and (-dy, dx), finite for zero
    and negative ranges."""
    rng = z_rb[..., 0]
    theta = pose[..., 2] + z_rb[..., 1]
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    dx = rng * cos_t
    dy = rng * sin_t
    mean = torch.stack([pose[..., 0] + dx, pose[..., 1] + dy], dim=-1)
    var_range = (cfg.stdRange * cfg.birthNoiseFactor) ** 2
    var_bearing = (cfg.stdBearing * cfg.birthNoiseFactor) ** 2
    c00 = cos_t * cos_t * var_range + dy * dy * var_bearing
    c01 = cos_t * sin_t * var_range - dy * dx * var_bearing
    c11 = sin_t * sin_t * var_range + dx * dx * var_bearing
    cov = torch.stack([torch.stack([c00, c01], dim=-1),
                       torch.stack([c01, c11], dim=-1)], dim=-2)
    return mean, cov


def birth_gaussian_4d(pose, z_rb, cfg):
    """4-D dynamic-feature birth: the 2-D birth's position block, zero
    velocity mean and diag(covVxBirth, covVyBirth) velocity covariance.
    Returns (mean [..., 4], cov [..., 4, 4])."""
    mean2, cov2 = birth_gaussian(pose, z_rb, cfg)
    mean4 = torch.cat([mean2, torch.zeros_like(mean2)], dim=-1)
    cov4 = cov2.new_zeros(mean2.shape[:-1] + (4, 4))
    cov4[..., :2, :2] = cov2
    cov4[..., 2, 2] = cfg.covVxBirth
    cov4[..., 3, 3] = cfg.covVyBirth
    return mean4, cov4

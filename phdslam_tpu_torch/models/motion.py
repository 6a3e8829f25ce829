"""Vehicle motion models (``phdslam_tpu/models/motion.py``). The caller
draws the noise, so both functions are deterministic."""

from __future__ import annotations

import torch

from phdslam_tpu_torch.ops.linalg import wrap_angle


def ackerman_predict(pose, control, noise, cfg, dt):
    """Ackerman-steering prediction. pose [..., 6]; control (v_encoder,
    alpha); noise [..., 2] scaled (encoder, steering) noise. Velocities in
    the output are zero, as in the reference."""
    v_encoder, alpha = control
    theta = pose[..., 2]
    ve = v_encoder + noise[..., 0]
    al = alpha + noise[..., 1]
    vc = ve / (1.0 - torch.tan(al) * cfg.h / cfg.l)
    xc_dot = vc * torch.cos(theta)
    yc_dot = vc * torch.sin(theta)
    thetac_dot = vc * torch.tan(al) / cfg.l
    px = pose[..., 0] + dt * (
        xc_dot - thetac_dot * (cfg.a * torch.sin(theta)
                               + cfg.b * torch.cos(theta)))
    py = pose[..., 1] + dt * (
        yc_dot + thetac_dot * (cfg.a * torch.cos(theta)
                               - cfg.b * torch.sin(theta)))
    ptheta = wrap_angle(theta + dt * thetac_dot)
    zeros = torch.zeros_like(px)
    return torch.stack([px, py, ptheta, zeros, zeros, zeros], dim=-1)


def cv_predict(pose, noise, dt):
    """Constant-velocity prediction; noise [..., 3] accelerations."""
    theta = pose[..., 2]
    vx, vy, vtheta = pose[..., 3], pose[..., 4], pose[..., 5]
    ax, ay, ath = noise[..., 0], noise[..., 1], noise[..., 2]
    c, s = torch.cos(theta), torch.sin(theta)
    px = (pose[..., 0] + dt * (vx * c - vy * s)
          + 0.5 * dt * dt * (ax * c - ay * s))
    py = (pose[..., 1] + dt * (vx * s + vy * c)
          + 0.5 * dt * dt * (ax * s + ay * c))
    ptheta = wrap_angle(theta + dt * vtheta + 0.5 * dt * dt * ath)
    return torch.stack(
        [px, py, ptheta, vx + dt * ax, vy + dt * ay, vtheta + dt * ath],
        dim=-1)

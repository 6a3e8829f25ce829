"""Vehicle and feature motion models (``phdslam_tpu/models/motion.py``).
The caller draws the noise, so every function is deterministic."""

from __future__ import annotations

import torch

from phdslam_tpu_torch.ops.linalg import logistic, wrap_angle


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


def cv_feature_q(dt, var_x, var_y, dtype=torch.float32, device=None):
    """White-acceleration process noise of the 4-D CV feature model, in
    (x, y, vx, vy) order: per axis var * [[dt^4/4, dt^3/2], [dt^3/2,
    dt^2]]. var_x, var_y floats ([4, 4]) or tensors [...] ([..., 4, 4]);
    the products in float64, then cast to dtype."""
    d4, d3, d2 = dt ** 4 / 4.0, dt ** 3 / 2.0, dt ** 2
    vx, vy = torch.broadcast_tensors(
        torch.as_tensor(var_x, dtype=torch.float64, device=device),
        torch.as_tensor(var_y, dtype=torch.float64, device=device))
    z = torch.zeros_like(vx)
    rows = ((d4 * vx, z, d3 * vx, z), (z, d4 * vy, z, d3 * vy),
            (d3 * vx, z, d2 * vx, z), (z, d3 * vy, z, d2 * vy))
    return torch.stack([torch.stack(r, -1) for r in rows], -2).to(dtype)


def cv_feature_predict(mean, cov, cfg, dt, scale_x=1.0, scale_y=1.0):
    """4-D feature CV prediction: mean' = F mean, cov' = F cov F^T + Q.
    mean [..., 4], cov [..., 4, 4]; scale_x, scale_y multiply the
    configured acceleration variances (floats, or tensors that broadcast
    against the batch)."""
    f = torch.eye(4, dtype=mean.dtype, device=mean.device)
    f[0, 2] = f[1, 3] = dt
    var_x = cfg.stdAxMap ** 2 * scale_x
    var_y = cfg.stdAyMap ** 2 * scale_y
    q = cv_feature_q(dt, var_x, var_y, mean.dtype, mean.device)
    mean_p = mean @ f.T
    cov_p = f @ cov @ f.T + q
    return mean_p, cov_p


def cp_feature_predict(mean, cov, cfg, dt):
    """2-D constant-position feature: additive diagonal noise
    ((stdVxMap dt)^2, (stdVyMap dt)^2)."""
    q = torch.tensor([[(cfg.stdVxMap * dt) ** 2, 0.0],
                      [0.0, (cfg.stdVyMap * dt) ** 2]], dtype=cov.dtype,
                     device=cov.device)
    return mean, cov + q


def jump_markov_split(w, mean, cfg, feature_model):
    """Survival and jump-Markov weight scaling of dynamic features. w
    [...], mean [..., 4]. Returns (w_dynamic, w_jump, scale_x, scale_y):
    the dynamic map keeps p_jmm ps w, the static jump copies carry
    (1 - p_jmm) w; feature_model 1 (dynamic) scales the acceleration
    noise per axis, 2 (mixed) does not."""
    vx, vy = mean[..., 2], mean[..., 3]
    v_mag = torch.sqrt(vx * vx + vy * vy)
    if feature_model == 1:
        p_jmm = torch.ones_like(v_mag)
        ps = 1.0 - logistic(v_mag, 0.0, 1.0 - cfg.ps, cfg.beta, cfg.tau)
        scale_x = logistic(vx, 0.0, 1.0, cfg.beta, cfg.tau)
        scale_y = logistic(vy, 0.0, 1.0, cfg.beta, cfg.tau)
    else:
        p_jmm = 1.0 / (1.0 + torch.exp(cfg.beta * (cfg.tau - v_mag)))
        ps = torch.full_like(v_mag, cfg.ps)
        scale_x = torch.ones_like(v_mag)
        scale_y = torch.ones_like(v_mag)
    return p_jmm * ps * w, (1.0 - p_jmm) * w, scale_x, scale_y

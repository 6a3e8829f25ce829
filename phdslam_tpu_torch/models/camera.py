"""Camera geometry of the monocular SC-PHD (disparity-space) pipeline, a
port of ``phdslam_tpu/models/camera.py``.

6-DOF camera pose [x, y, z, roll, pitch, yaw] with the reference's expanded
rotation matrix; disparity space with baseline 1: u = u0 - fx xc / zc,
v = v0 - fy yc / zc, d = -fx / zc, visible when u in (0, W), v in (0, H) and
d >= 0. Every function is elementwise over broadcastable tensors.
"""

from __future__ import annotations

import torch

from phdslam_tpu_torch.ops.linalg import wrap_angle


def _rotation_terms(pose):
    """The nine entries of the camera -> world rotation, row by row."""
    roll, pitch, yaw = pose[..., 3], pose[..., 4], pose[..., 5]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return (cp * cy, cr * sy + sr * sp * cy, sr * sy - cr * sp * cy,
            -cp * sy, cr * cy - sr * sp * sy, sr * cy + cr * sp * sy,
            sp, -sr * cp, cr * cp)


def camera_to_world(xc, yc, zc, pose, is_point=True):
    """pose [..., >= 6]; xc, yc, zc broadcast against its batch dims."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rotation_terms(pose)
    xw = xc * r00 + yc * r01 + zc * r02
    yw = xc * r10 + yc * r11 + zc * r12
    zw = xc * r20 + yc * r21 + zc * r22
    if is_point:
        xw = xw + pose[..., 0]
        yw = yw + pose[..., 1]
        zw = zw + pose[..., 2]
    return xw, yw, zw


def world_to_camera(xw, yw, zw, pose, is_point=True):
    """The transposed rotation of ``camera_to_world``."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rotation_terms(pose)
    if is_point:
        xw = xw - pose[..., 0]
        yw = yw - pose[..., 1]
        zw = zw - pose[..., 2]
    xc = xw * r00 + yw * r10 + zw * r20
    yc = xw * r01 + yw * r11 + zw * r21
    zc = xw * r02 + yw * r12 + zw * r22
    return xc, yc, zc


def world_to_disparity(xw, yw, zw, pose, cfg):
    """Returns (u, v, d, in_fov); zc below 1e-12 in magnitude becomes
    1e-12."""
    xc, yc, zc = world_to_camera(xw, yw, zw, pose)
    zc_safe = torch.where(torch.abs(zc) < 1e-12, 1e-12, zc)
    u = cfg.u0 - cfg.fx * xc / zc_safe
    v = cfg.v0 - cfg.fy * yc / zc_safe
    d = -cfg.fx / zc_safe
    in_fov = ((u > 0) & (u < cfg.imageWidth)
              & (v > 0) & (v < cfg.imageHeight) & (d >= 0))
    return u, v, d, in_fov


def disparity_to_world(u, v, d, pose, cfg):
    """Inverse of ``world_to_disparity``; d below 1e-12 in magnitude becomes
    1e-12."""
    d_safe = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    xc = (u - cfg.u0) / d_safe
    yc = cfg.fx / cfg.fy * (v - cfg.v0) / d_safe
    zc = -cfg.fx / d_safe
    return camera_to_world(xc, yc, zc, pose)


def camera_cv_predict(pose, noise, cfg, dt):
    """6-DOF constant-velocity prediction with acceleration noise: the
    translation integrates the velocity in the camera frame, then rotates to
    the world; the angles wrap.

    pose [..., 12] = [x y z roll pitch yaw vx vy vz vroll vpitch vyaw];
    noise [..., 6] the accelerations, already scaled."""
    dxc = dt * pose[..., 6] + 0.5 * noise[..., 0] * dt * dt
    dyc = dt * pose[..., 7] + 0.5 * noise[..., 1] * dt * dt
    dzc = dt * pose[..., 8] + 0.5 * noise[..., 2] * dt * dt
    dxw, dyw, dzw = camera_to_world(dxc, dyc, dzc, pose, is_point=False)
    ang = [wrap_angle(pose[..., 3 + i] + dt * pose[..., 9 + i]
                      + 0.5 * noise[..., 3 + i] * dt * dt) for i in range(3)]
    vel = [pose[..., 6 + i] + dt * noise[..., i] for i in range(6)]
    return torch.stack([pose[..., 0] + dxw, pose[..., 1] + dyw,
                        pose[..., 2] + dzw, *ang, *vel], dim=-1)

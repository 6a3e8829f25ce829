"""Kernel 9: the Kalman pre-update of the 2-D static map in one pass.

Replaces no TPU kernel: the JAX package leaves
``phdslam_tpu/filter/update.py::kalman_preupdate`` to XLA, which fuses
it. ``preupdate_cuda`` launches ``csrc/preupdate.cu``; ``preupdate_plain``
is the same chain of [P, F] channel arithmetic in plain PyTorch (about 170
elementwise launches on a GPU). ``kalman_preupdate`` runs the first on
CUDA tensors and the second on CPU tensors. Both take the pose [P, >= 3]
and the map's six [P, F] channels and return ``PreUpdate``; on the card
the kernel's channels equal the plain version's run there bit for bit
(the kernel's note says how). The kernel's 14 float channels are views of
one [14, P, F] block, each contiguous; ``rclass`` is int32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from phdslam_tpu_torch.kernels import _build
from phdslam_tpu_torch.models.measurement import (predict_measurement,
                                                  range_class)

#: kernel launches since the count was last set to 0
launches = 0


class PreUpdate(NamedTuple):
    """Measurement-independent Kalman terms, all [P, F] channels."""

    r: torch.Tensor
    bearing: torch.Tensor
    pd: torch.Tensor
    rclass: torch.Tensor         # 0 = out, 1 = in, 2 = near (0 when empty)
    g00: torch.Tensor            # Kalman gain
    g01: torch.Tensor
    g10: torch.Tensor
    g11: torch.Tensor
    u00: torch.Tensor            # Joseph-form updated covariance
    u01: torch.Tensor
    u11: torch.Tensor
    si00: torch.Tensor           # innovation covariance inverse
    si01: torch.Tensor
    si11: torch.Tensor
    log_det_s: torch.Tensor


def preupdate_plain(pose, gm, cfg) -> PreUpdate:
    """EKF terms per (particle, feature): S = J P J^T + R, K = P J^T S^-1,
    P' = (I - K J) P (I - K J)^T + K R K^T."""
    mean_xy = torch.stack([gm.mx, gm.my], dim=-1)
    r, b, dx, dy, _ = predict_measurement(pose[:, None, :], mean_xy)
    rc = range_class(r, b, cfg)
    rc = torch.where(gm.valid, rc, 0)
    in_mask = rc == 1
    pd = torch.where(in_mask, cfg.pd, 0.0).to(gm.w.dtype)

    # Slots outside the update (empty or not in range) get the benign
    # geometry dx = 1, dy = 0, so every Kalman term stays finite and no
    # 0 * inf reaches the merge's weighted sums.
    dx = torch.where(in_mask, dx, 1.0)
    dy = torch.where(in_mask, dy, 0.0)
    r2s = dx * dx + dy * dy
    rs = torch.sqrt(r2s)

    j00 = dx / rs
    j01 = dy / rs
    j10 = -dy / r2s
    j11 = dx / r2s

    p00, p01, p11 = gm.c00, gm.c01, gm.c11
    var_r = cfg.stdRange ** 2
    var_b = cfg.stdBearing ** 2

    a00 = j00 * (j00 * p00 + j01 * p01) + j01 * (j00 * p01 + j01 * p11)
    a01 = j10 * (j00 * p00 + j01 * p01) + j11 * (j00 * p01 + j01 * p11)
    a11 = j10 * (j10 * p00 + j11 * p01) + j11 * (j10 * p01 + j11 * p11)

    s00 = a00 + var_r
    s01 = a01
    s11 = a11 + var_b

    # Cancellation-free determinant: det(A + R) = det(P) / r^2
    # + a00 var_b + a11 var_r + var_r var_b, every term nonnegative, floored
    # at det(R). The naive s00 s11 - s01^2 loses everything in float32 once
    # the covariances grow.
    det_p = torch.clamp(p00 * p11 - p01 * p01, min=0.0)
    det_s = det_p / r2s + a00 * var_b + a11 * var_r + var_r * var_b
    det_s = torch.clamp(det_s, min=var_r * var_b)

    si00 = s11 / det_s
    si01 = -s01 / det_s
    si11 = s00 / det_s

    t00 = p00 * j00 + p01 * j01
    t01 = p00 * j10 + p01 * j11
    t10 = p01 * j00 + p11 * j01
    t11 = p01 * j10 + p11 * j11
    g00 = t00 * si00 + t01 * si01
    g01 = t00 * si01 + t01 * si11
    g10 = t10 * si00 + t11 * si01
    g11 = t10 * si01 + t11 * si11

    l00 = 1.0 - (g00 * j00 + g01 * j10)
    l01 = -(g00 * j01 + g01 * j11)
    l10 = -(g10 * j00 + g11 * j10)
    l11 = 1.0 - (g10 * j01 + g11 * j11)
    q00 = l00 * p00 + l01 * p01
    q01 = l00 * p01 + l01 * p11
    q10 = l10 * p00 + l11 * p01
    q11 = l10 * p01 + l11 * p11
    u00 = q00 * l00 + q01 * l01 + g00 * g00 * var_r + g01 * g01 * var_b
    u01 = q00 * l10 + q01 * l11 + g00 * g10 * var_r + g01 * g11 * var_b
    u11 = q10 * l10 + q11 * l11 + g10 * g10 * var_r + g11 * g11 * var_b

    return PreUpdate(r=r, bearing=b, pd=pd, rclass=rc, g00=g00, g01=g01,
                     g10=g10, g11=g11, u00=u00, u01=u01, u11=u11, si00=si00,
                     si01=si01, si11=si11, log_det_s=torch.log(det_s))


def preupdate_cuda(pose, gm, cfg) -> PreUpdate:
    """Launch ``csrc/preupdate.cu`` on PyTorch's current stream."""
    global launches
    chans = [c.contiguous() for c in (gm.w, gm.mx, gm.my, gm.c00, gm.c01,
                                      gm.c11)]
    P, F = chans[0].shape
    dev = chans[0].device
    if dev.type != "cuda":
        raise ValueError(f"preupdate kernel: channels on {dev}, not CUDA")
    for c in chans:
        _build.check_tensor(c, (P, F), dev, "map channel")
    pose = pose.contiguous()
    if pose.dim() != 2 or pose.shape[0] != P or pose.shape[1] < 3:
        raise ValueError(f"pose must be [{P}, >= 3], got "
                         f"{tuple(pose.shape)}")
    _build.check_tensor(pose, tuple(pose.shape), dev, "pose")
    lib, _ = _build.library()
    out = torch.empty((14, P, F), dtype=torch.float32, device=dev)
    rclass = torch.empty((P, F), dtype=torch.int32, device=dev)
    # the plain chain's Python scalars; ctypes rounds each to float32
    var_r = cfg.stdRange ** 2
    var_b = cfg.stdBearing ** 2
    scalars = (var_r, var_b, var_r * var_b, cfg.pd, cfg.minRange,
               cfg.maxRange, cfg.maxBearing, 0.8 * cfg.minRange,
               1.2 * cfg.maxRange, 1.2 * cfg.maxBearing, 2.0 * math.pi,
               math.pi)
    err = lib.phd_preupdate_launch(
        *(c.data_ptr() for c in chans), pose.data_ptr(), pose.shape[1],
        out.data_ptr(), rclass.data_ptr(), P, F, *map(float, scalars),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "preupdate kernel")
    launches += 1
    (r, b, pd, g00, g01, g10, g11, u00, u01, u11, si00, si01, si11,
     lds) = out.unbind(0)
    return PreUpdate(r=r, bearing=b, pd=pd, rclass=rclass, g00=g00,
                     g01=g01, g10=g10, g11=g11, u00=u00, u01=u01, u11=u11,
                     si00=si00, si01=si01, si11=si11, log_det_s=lds)


def kalman_preupdate(pose, gm, cfg) -> PreUpdate:
    """The pre-update of the map gm [P, F] seen from pose [P, >= 3]: the
    kernel on CUDA tensors, its plain version on CPU tensors."""
    run = _build.kernel_for(gm.w.device, preupdate_cuda, preupdate_plain,
                            "preupdate")
    return run(pose, gm, cfg)

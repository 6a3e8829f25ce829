"""Kernel 1: fused likelihood, normaliser and top-k1 selection.

Replaces ``phdslam_tpu/kernels/preupdate_pallas.py::fused_update_select``.
``fused_update_select`` launches ``csrc/select.cu`` (``select_cuda``) on
CUDA tensors and runs ``select_plain``, the same function in plain
PyTorch, on CPU tensors. The outputs have the layouts the JAX wrapper
returns after its transposes: ``sum_exp [P, M]``, seven ``[P, M, k1]``
channels (w, mx, my, u00, u01, u11, lpw) and ``compat [P, M]`` bool.
Columns at or past ``n_valid`` are zero.
"""

from __future__ import annotations

import math

import torch

from phdslam_tpu_torch.kernels import _build
from phdslam_tpu_torch.ops.linalg import safe_log

LOG_2PI = 1.8378770664093453
NEG_LARGE = -1e30

#: kernel launches since the count was last set to 0
launches = 0


def _wrap_round(x):
    two_pi = 2.0 * math.pi
    return x - two_pi * torch.round(x / two_pi)


def select_plain(chans, z, n_valid, *, k1: int, clutter_birth: float,
                 min_weight: float, gate_threshold: float, raw: bool = False,
                 with_compat: bool = True, with_lpw: bool = True):
    """The kernel's function in PyTorch ops: builds the [P, M, F] terms and
    picks with k1 argmax rounds (largest first, lowest index on ties).
    chans: the 16 [P, F] channels (r, b, lpw, si00, si01, si11, lds, mx,
    my, g00, g01, g10, g11, u00, u01, u11); z [M, 2]; n_valid int32 [1]."""
    (r, b, lpw, si00, si01, si11, lds, mx, my, g00, g01, g10, g11, u00, u01,
     u11) = chans
    P, F = r.shape
    M = z.shape[0]
    base = lpw - LOG_2PI - 0.5 * lds
    ir = z[None, :, None, 0] - r[:, None, :]                  # [P, M, F]
    ib = _wrap_round(z[None, :, None, 1] - b[:, None, :])
    d2 = (ir * ir * si00[:, None, :] + 2.0 * ir * ib * si01[:, None, :]
          + ib * ib * si11[:, None, :])
    d2 = torch.clamp(d2, min=0.0)
    e = torch.exp(base[:, None, :] - 0.5 * d2)
    s = e.sum(-1)                                             # [P, M]
    if with_compat:
        in_rng = (lpw > 0.5 * NEG_LARGE)[:, None, :]
        compat = (in_rng & (d2 < gate_threshold)).any(-1)
    else:
        compat = torch.zeros((P, M), dtype=torch.bool, device=r.device)
    if raw:
        wrem = e
    else:
        wrem = e * (1.0 / (s + clutter_birth))[..., None]
        wrem = torch.where(wrem >= min_weight, wrem, 0.0)
    del d2, e
    live = torch.arange(M, device=r.device) < n_valid.reshape(())
    picks = []
    for _ in range(k1):
        first = torch.argmax(wrem, dim=-1, keepdim=True)      # [P, M, 1]
        picks.append((torch.gather(wrem, -1, first), first))
        wrem = wrem.scatter(-1, first, 0.0)
    w_sel = torch.cat([v for v, _ in picks], -1)              # [P, M, k1]
    f_sel = torch.cat([i for _, i in picks], -1)
    take = lambda a: torch.gather(a[:, None, :].expand(P, M, F), 2, f_sel)
    ir_s = z[None, :, None, 0] - take(r)
    ib_s = _wrap_round(z[None, :, None, 1] - take(b))
    sel = [torch.where(w_sel > 0.0, w_sel, 0.0),
           take(mx) + take(g00) * ir_s + take(g01) * ib_s,
           take(my) + take(g10) * ir_s + take(g11) * ib_s,
           take(u00), take(u01), take(u11),
           take(lpw) if with_lpw else torch.zeros_like(w_sel)]
    m2 = live[None, :]
    sel = [torch.where(m2[..., None], a, 0.0) for a in sel]
    return (torch.where(m2, s, 0.0), *sel, compat & m2)


def select_cuda(chans, z, n_valid, *, k1: int, clutter_birth: float,
                min_weight: float, gate_threshold: float, raw: bool = False,
                with_compat: bool = True, with_lpw: bool = True):
    """Launch ``csrc/select.cu`` on PyTorch's current stream."""
    global launches
    r = chans[0]
    P, F = r.shape
    M = z.shape[0]
    dev = r.device
    for c in chans:
        _check(c, (P, F), dev, "channel")
    _check(z, (M, 2), dev, "z")
    if n_valid.dtype != torch.int32 or n_valid.numel() != 1 \
            or n_valid.device != dev:
        raise ValueError("n_valid must be one int32 on the channels' device")
    if not 1 <= k1 <= 32:
        raise ValueError(f"k1 must be in [1, 32], got {k1}")
    lib, _ = _build.library()
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    outs = [f32(P, M)] + [f32(P, M, k1) for _ in range(7)]
    compat = torch.empty((P, M), dtype=torch.bool, device=dev)
    err = lib.phd_select_launch(
        *(c.data_ptr() for c in chans), z.data_ptr(), n_valid.data_ptr(),
        *(o.data_ptr() for o in outs), compat.data_ptr(),
        P, F, M, k1, clutter_birth, min_weight, gate_threshold,
        int(raw), int(with_compat), int(with_lpw),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "select kernel")
    launches += 1
    return (*outs, compat)


def _check(t, shape, device, name):
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous float32 {tuple(shape)} on {device},"
            f" got {t.dtype} {tuple(t.shape)} on {t.device}")


def select_channels(pre, gm):
    """The 16 [P, F] kernel inputs, lpw = max(log pd + log w, -1e30)."""
    lpw = torch.clamp(safe_log(pre.pd) + safe_log(gm.w), min=NEG_LARGE)
    return [pre.r, pre.bearing, lpw, pre.si00, pre.si01, pre.si11,
            pre.log_det_s, gm.mx, gm.my, pre.g00, pre.g01, pre.g10,
            pre.g11, pre.u00, pre.u01, pre.u11]


def fused_update_select(z_rb, pre, gm, cfg, k1: int = 8, raw: bool = False,
                        n_valid=None, with_compat=None, with_lpw=None):
    """Counterpart of the JAX wrapper: returns (sum_exp, w_sel, mx_sel,
    my_sel, u00_sel, u01_sel, u11_sel, lpw_sel, compat). The kernel on CUDA
    tensors, its plain version on CPU tensors. n_valid is a device int32
    (1 + the last valid measurement index); None means all M."""
    if with_compat is None:
        with_compat = bool(cfg.gateBirths)
    if with_lpw is None:
        with_lpw = cfg.particleWeighting == 2
    dev = z_rb.device
    if dev.type == "cuda":
        run = select_cuda
    elif dev.type == "cpu":
        run = select_plain
    else:
        raise ValueError(f"no select kernel for device {dev}")
    if n_valid is None:
        n_valid = torch.full((1,), z_rb.shape[0], dtype=torch.int32,
                             device=dev)
    chans = [c.contiguous() for c in select_channels(pre, gm)]
    return run(
        chans, z_rb.contiguous(), n_valid.reshape(1).to(torch.int32), k1=k1,
        clutter_birth=float(cfg.clutterDensity + cfg.birthWeight),
        min_weight=float(cfg.minFeatureWeight),
        gate_threshold=float(cfg.gateThreshold), raw=raw,
        with_compat=with_compat, with_lpw=with_lpw)

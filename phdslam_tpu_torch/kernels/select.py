"""Kernels 1 and 2: fused likelihood, normaliser and top-k1 selection of the
2-D static map.

Replaces ``phdslam_tpu/kernels/preupdate_pallas.py::fused_update_select``
and its index mode ``fused_update_select_by_index``; both run
``csrc/select.cu``, the second with ``by_index = 1``. The wrappers launch
the kernel on CUDA tensors (``select_cuda``) and run ``select_plain``, the
same function in plain PyTorch, on CPU tensors. The outputs have the
layouts the JAX wrappers return after their transposes: ``sum_exp [P, M]``,
then seven ``[P, M, k1]`` channels (w, mx, my, u00, u01, u11, lpw) or, by
index, ``w [P, M, k1]`` and ``idx [P, M, k1]`` int32 (0 where w = 0), and
``compat [P, M]`` bool. Columns at or past ``n_valid`` are zero. The kernels
keep a row of up to 1024 map slots in registers; a wider one runs their
wide-row path, the row in device-memory scratch that the wrapper allocates
(``_build.scratch``), so any F runs on both devices.
"""

from __future__ import annotations

import math

import torch

from phdslam_tpu_torch.kernels import _build
from phdslam_tpu_torch.ops.linalg import safe_log

LOG_2PI = 1.8378770664093453
NEG_LARGE = -1e30
N_LOOP = 7                       # channels the (p, m, f) loop reads

#: launches of the payload kernel since the count was last set to 0
launches = 0
#: launches of the by-index kernel since the count was last set to 0
launches_by_index = 0


def _wrap_round(x):
    """The kernels' bearing wrap, x - 2 pi round(x / 2 pi), with the IEEE
    float32 quotient on every device: 2 pi is a tensor on x's device, since
    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which rounds differently next to a half-turn."""
    two_pi = x.new_tensor(2.0 * math.pi)
    return x - two_pi * torch.round(x / two_pi)


def likelihoods(loop_chans, z):
    """The [P, M, F] terms e = exp(lpw - log 2pi - lds/2 - d2/2) and d2 of
    the kernels' inner loop, from the seven loop channels (r, b, lpw, si00,
    si01, si11, lds) and z [M, 2]."""
    r, b, lpw, si00, si01, si11, lds = loop_chans
    base = lpw - LOG_2PI - 0.5 * lds
    ir = z[None, :, None, 0] - r[:, None, :]                  # [P, M, F]
    ib = _wrap_round(z[None, :, None, 1] - b[:, None, :])
    d2 = (ir * ir * si00[:, None, :] + 2.0 * ir * ib * si01[:, None, :]
          + ib * ib * si11[:, None, :])
    d2 = torch.clamp(d2, min=0.0)
    return torch.exp(base[:, None, :] - 0.5 * d2), d2


def top_k1(wrem, k1: int):
    """k1 argmax rounds over the last axis (largest first, lowest index on
    ties), each zeroing its winner: (w_sel, f_sel) [..., k1], w_sel
    clamped at 0."""
    picks = []
    for _ in range(k1):
        first = torch.argmax(wrem, dim=-1, keepdim=True)
        picks.append((torch.gather(wrem, -1, first), first))
        wrem = wrem.scatter(-1, first, 0.0)
    w_sel = torch.cat([v for v, _ in picks], -1)
    f_sel = torch.cat([i for _, i in picks], -1)
    return torch.where(w_sel > 0.0, w_sel, 0.0), f_sel


def check_shape(F: int, k1: int):
    """Raise unless the select kernels take F slots and k1 picks."""
    if F < 1:
        raise ValueError(f"the select kernels need a map slot, got {F}")
    if not 1 <= k1 <= 32:
        raise ValueError(f"k1 must be in [1, 32], got {k1}")


def select_plain(chans, z, n_valid, *, k1: int, clutter_birth: float,
                 min_weight: float, gate_threshold: float, raw: bool = False,
                 with_compat: bool = True, with_lpw: bool = True,
                 by_index: bool = False):
    """The kernel's function in PyTorch ops: builds the [P, M, F] terms and
    picks with k1 argmax rounds. chans: the 16 [P, F] channels (r, b, lpw,
    si00, si01, si11, lds, mx, my, g00, g01, g10, g11, u00, u01, u11), or
    the first seven by index; z [M, 2]; n_valid int32 [1]."""
    r, b, lpw = chans[:3]
    P, F = r.shape
    M = z.shape[0]
    e, d2 = likelihoods(chans[:N_LOOP], z)
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
    w_sel, f_sel = top_k1(wrem, k1)
    live = (torch.arange(M, device=r.device) < n_valid.reshape(()))[None, :]
    mask = lambda a: torch.where(live[..., None], a, 0)
    if by_index:
        idx = torch.where(w_sel > 0.0, f_sel, 0).to(torch.int32)
        return (torch.where(live, s, 0.0), mask(w_sel), mask(idx),
                compat & live)
    (mx, my, g00, g01, g10, g11, u00, u01, u11) = chans[N_LOOP:]
    take = lambda a: torch.gather(a[:, None, :].expand(P, M, F), 2, f_sel)
    ir_s = z[None, :, None, 0] - take(r)
    ib_s = _wrap_round(z[None, :, None, 1] - take(b))
    sel = [w_sel,
           take(mx) + take(g00) * ir_s + take(g01) * ib_s,
           take(my) + take(g10) * ir_s + take(g11) * ib_s,
           take(u00), take(u01), take(u11),
           take(lpw) if with_lpw else torch.zeros_like(w_sel)]
    return (torch.where(live, s, 0.0), *map(mask, sel), compat & live)


def select_cuda(chans, z, n_valid, *, k1: int, clutter_birth: float,
                min_weight: float, gate_threshold: float, raw: bool = False,
                with_compat: bool = True, with_lpw: bool = True,
                by_index: bool = False):
    """Launch ``csrc/select.cu`` on PyTorch's current stream."""
    global launches, launches_by_index
    r = chans[0]
    P, F = r.shape
    M = z.shape[0]
    dev = r.device
    if len(chans) != (N_LOOP if by_index else 16):
        raise ValueError(f"select kernel takes {N_LOOP if by_index else 16} "
                         f"channels here, got {len(chans)}")
    for c in chans:
        _build.check_tensor(c, (P, F), dev, "channel")
    _build.check_tensor(z, (M, 2), dev, "z")
    if n_valid.dtype != torch.int32 or n_valid.numel() != 1 \
            or n_valid.device != dev:
        raise ValueError("n_valid must be one int32 on the channels' device")
    check_shape(F, k1)
    lib, _ = _build.library()
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    sum_exp, w_sel = f32(P, M), f32(P, M, k1)
    compat = torch.empty((P, M), dtype=torch.bool, device=dev)
    if by_index:
        idx = torch.empty((P, M, k1), dtype=torch.int32, device=dev)
        payload, ptrs_in = [], [None] * 9
        ptrs_out = [None] * 6 + [idx.data_ptr()]
    else:
        payload = [f32(P, M, k1) for _ in range(6)]
        ptrs_in = [c.data_ptr() for c in chans[N_LOOP:]]
        ptrs_out = [o.data_ptr() for o in payload] + [None]
    scratch = _build.scratch(lib.phd_select_wide_floats(P, F), dev)
    err = lib.phd_select_launch(
        *(c.data_ptr() for c in chans[:N_LOOP]), *ptrs_in, z.data_ptr(),
        n_valid.data_ptr(), sum_exp.data_ptr(), w_sel.data_ptr(), *ptrs_out,
        compat.data_ptr(), P, F, M, k1, clutter_birth, min_weight,
        gate_threshold, int(raw), int(with_compat), int(with_lpw),
        int(by_index), _build.ptr(scratch),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "select kernel")
    if by_index:
        launches_by_index += 1
        return sum_exp, w_sel, idx, compat
    launches += 1
    return (sum_exp, w_sel, *payload, compat)


def loop_lpw(pre, gm):
    """lpw = max(log pd + log w, -1e30), the kernels' in-range marker."""
    return torch.clamp(safe_log(pre.pd) + safe_log(gm.w), min=NEG_LARGE)


def select_channels(pre, gm):
    """The 16 [P, F] kernel inputs; the first seven are the loop's."""
    return [pre.r, pre.bearing, loop_lpw(pre, gm), pre.si00, pre.si01,
            pre.si11, pre.log_det_s, gm.mx, gm.my, pre.g00, pre.g01,
            pre.g10, pre.g11, pre.u00, pre.u01, pre.u11]


def _select(z_rb, pre, gm, cfg, k1, raw, n_valid, with_compat, with_lpw,
            by_index):
    dev = z_rb.device
    if n_valid is None:
        n_valid = torch.full((1,), z_rb.shape[0], dtype=torch.int32,
                             device=dev)
    chans = select_channels(pre, gm)[:N_LOOP if by_index else 16]
    run = _build.kernel_for(dev, select_cuda, select_plain, "select")
    return run(
        [c.contiguous() for c in chans], z_rb.contiguous(),
        n_valid.reshape(1).to(torch.int32), k1=k1,
        clutter_birth=float(cfg.clutterDensity + cfg.birthWeight),
        min_weight=float(cfg.minFeatureWeight),
        gate_threshold=float(cfg.gateThreshold), raw=raw,
        with_compat=with_compat, with_lpw=with_lpw, by_index=by_index)


def fused_update_select(z_rb, pre, gm, cfg, k1: int = 8, raw: bool = False,
                        n_valid=None, with_compat=None, with_lpw=None):
    """Counterpart of the JAX wrapper: returns (sum_exp, w_sel, mx_sel,
    my_sel, u00_sel, u01_sel, u11_sel, lpw_sel, compat). n_valid is a
    device int32 (1 + the last valid measurement index); None means all
    M."""
    if with_compat is None:
        with_compat = bool(cfg.gateBirths)
    if with_lpw is None:
        with_lpw = cfg.particleWeighting == 2
    return _select(z_rb, pre, gm, cfg, k1, raw, n_valid, with_compat,
                   with_lpw, False)


def fused_update_select_by_index(z_rb, pre, gm, cfg, k1: int = 8,
                                 raw: bool = False, n_valid=None,
                                 with_compat=None):
    """Counterpart of the JAX wrapper of the same name: the picks of
    ``fused_update_select`` as (sum_exp, w_sel, idx_sel int32, compat); the
    caller gathers the payload (``filter/update.gather_selected``)."""
    if with_compat is None:
        with_compat = bool(cfg.gateBirths)
    return _select(z_rb, pre, gm, cfg, k1, raw, n_valid, with_compat, False,
                   True)

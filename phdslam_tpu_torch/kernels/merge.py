"""Kernel 2: greedy moment-matching merge of the candidate pool.

Replaces ``phdslam_tpu/kernels/merge_pallas.py::greedy_merge_pallas``.
``merge_cuda`` launches ``csrc/merge.cu``; ``merge_plain`` is the same
pick loop in plain PyTorch. ``ops/gm.py::greedy_merge_channels`` runs the
first on CUDA tensors and the second on CPU tensors. Both take six
``[P, K]`` candidate channels and return six ``[P, max_out]`` channels;
empty slots hold w = 0, mean 0 and the identity covariance.
"""

from __future__ import annotations

import torch

from phdslam_tpu_torch.kernels import _build

#: kernel launches since the count was last set to 0
launches = 0


def _near(metric, dx, dy, r00, r01, r11, c00, c01, c11, min_separation):
    """The kernel's neighbour test of each candidate against the pick."""
    if metric == 1:
        s00, s01, s11 = r00 + c00, r01 + c01, r11 + c11
        det_sum = s00 * s11 - s01 * s01
        safe = torch.clamp(det_sum, min=1.17549435e-38)
        eps_q = -0.25 * (dx * dx * s11 - 2.0 * dx * dy * s01
                         + dy * dy * s00) / safe
        det_prod = ((r00 * c00 + r01 * c01) * (r01 * c01 + r11 * c11)
                    - (r00 * c01 + r01 * c11) * (r01 * c00 + r11 * c01))
        dist = 1.0 - torch.sqrt(torch.clamp(
            torch.sqrt(torch.clamp(det_prod, min=0.0)) / (det_sum / 4.0),
            min=0.0)) * torch.exp(eps_q)
        return dist < min_separation
    a00 = 0.5 * (r00 + c00)
    a01 = 0.5 * (r01 + c01)
    a11 = 0.5 * (r11 + c11)
    det = a00 * a11 - a01 * a01
    # division-free form of quad / det < min_separation (det > 0)
    quad = dx * dx * a11 - 2.0 * (dx * dy) * a01 + dy * dy * a00
    return quad < min_separation * det


def merge_plain(w, mx, my, c00, c01, c11, min_separation: float,
                max_out: int, metric: int = 0):
    """The kernel's pick loop in PyTorch ops over all particles at once,
    with the kernel's one-pass moments centred on the pick."""
    P, K = w.shape
    z = lambda: torch.zeros((P, max_out), dtype=w.dtype, device=w.device)
    o = lambda: torch.ones((P, max_out), dtype=w.dtype, device=w.device)
    out = [z(), z(), z(), o(), z(), o()]
    w_rem = w.clone()
    col = torch.arange(K, device=w.device)
    for i in range(max_out):
        pick = torch.argmax(w_rem, dim=1, keepdim=True)       # first max
        mval = torch.gather(w_rem, 1, pick)
        if not bool((mval > 0.0).any()):
            break
        take = lambda a: torch.gather(a, 1, pick)
        rmx, rmy = take(mx), take(my)
        r00, r01, r11 = take(c00), take(c01), take(c11)
        dx = rmx - mx
        dy = rmy - my
        near = _near(metric, dx, dy, r00, r01, r11, c00, c01, c11,
                     min_separation)
        sel = (near & (w_rem > 0.0)) | (col[None, :] == pick)
        sel = sel & (mval > 0.0)
        sw = torch.where(sel, w_rem, 0.0)
        wsum = sw.sum(1)
        live = wsum > 0.0
        inv = torch.where(live, 1.0 / torch.clamp(wsum, min=1e-38), 0.0)
        mcx = (sw * dx).sum(1) * inv
        mcy = (sw * dy).sum(1) * inv
        n00 = (sw * (c00 + dx * dx)).sum(1) * inv - mcx * mcx
        n01 = (sw * (c01 + dx * dy)).sum(1) * inv - mcx * mcy
        n11 = (sw * (c11 + dy * dy)).sum(1) * inv - mcy * mcy
        vals = (wsum, torch.where(live, rmx[:, 0] - mcx, 0.0),
                torch.where(live, rmy[:, 0] - mcy, 0.0),
                torch.where(live, n00, 1.0), n01,
                torch.where(live, n11, 1.0))
        for dst, v in zip(out, vals):
            dst[:, i] = v
        w_rem = torch.where(sel, 0.0, w_rem)
    return tuple(out)


def merge_cuda(w, mx, my, c00, c01, c11, min_separation: float,
               max_out: int, metric: int = 0):
    """Launch ``csrc/merge.cu`` on PyTorch's current stream. A pool lives
    in one CTA's shared memory up to K = 7744; a wider one in device memory
    that this wrapper allocates, where the same code runs."""
    global launches
    chans = (w, mx, my, c00, c01, c11)
    P, K = w.shape
    dev = w.device
    for c in chans:
        if c.device != dev or c.dtype != torch.float32 \
                or tuple(c.shape) != (P, K) or not c.is_contiguous():
            raise ValueError(
                f"merge: expected contiguous float32 ({P}, {K}) on {dev}, "
                f"got {c.dtype} {tuple(c.shape)} on {c.device}")
    if metric not in (0, 1):
        raise ValueError(f"merge kernel has metrics 0 and 1, not {metric}")
    lib, _ = _build.library()
    outs = [torch.empty((P, max_out), dtype=torch.float32, device=dev)
            for _ in range(6)]
    scratch = _build.scratch(lib.phd_merge_wide_floats(P, K), dev)
    err = lib.phd_merge_launch(
        *(c.data_ptr() for c in chans), *(o.data_ptr() for o in outs),
        P, K, max_out, float(min_separation), int(metric),
        _build.ptr(scratch), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "merge kernel")
    launches += 1
    return tuple(outs)

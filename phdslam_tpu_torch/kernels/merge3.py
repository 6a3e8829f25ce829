"""Kernel 7: greedy moment-matching merge of the 3-D candidate pool (the
disparity-space features of the monocular SC-PHD pipeline).

Replaces ``phdslam_tpu/kernels/merge_pallas.py::greedy_merge3_pallas``.
``merge3_cuda`` launches ``csrc/merge3.cu``; ``merge3_plain`` is the same
pick loop in plain PyTorch. ``ops/gm.py::greedy_merge_channels3`` runs the
first on CUDA tensors and the second on CPU tensors. Both take ten ``[P, K]``
channels (w, m0, m1, m2, c00, c01, c02, c11, c12, c22) and return the same
ten channels ``[P, max_out]``; empty slots hold w = 0, mean 0 and the
identity covariance.

The moments are taken in one pass centred on the pick (as in ``merge4``),
where the JAX package takes the mean first and the moments about it; the two
agree to float32 rounding of the centred sums. The kernel runs the presorted
design of all three merges (``csrc/merge_common.cuh``): it adds each slot's
members in the greedy pick order (weight descending), the plain version in
index order, which again moves only the rounding. Its neighbour test is the
plain version's arithmetic (``mahalanobis3``), whole. A pool lives in one
CTA's shared memory up to K = 5051 (46 B per candidate); a wider one in
device memory that the wrapper allocates, where the same code runs.
"""

from __future__ import annotations

import torch

from phdslam_tpu_torch.kernels import _build

PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))   # cov channels

#: kernel launches since the count was last set to 0
launches = 0


def mahalanobis3(a, d):
    """d^T adj(A) d / det(A) for the symmetric 3x3 A with channels a (00,
    01, 02, 11, 12, 22) and the vector channels d (3): the closed-form
    adjugate and determinant, divided with no guard."""
    a00, a01, a02, a11, a12, a22 = a
    d0, d1, d2 = d
    det = (a00 * (a11 * a22 - a12 * a12)
           - a01 * (a01 * a22 - a12 * a02)
           + a02 * (a01 * a12 - a11 * a02))
    i00 = a11 * a22 - a12 * a12
    i01 = a02 * a12 - a01 * a22
    i02 = a01 * a12 - a02 * a11
    i11 = a00 * a22 - a02 * a02
    i12 = a02 * a01 - a00 * a12
    i22 = a00 * a11 - a01 * a01
    return (d0 * d0 * i00 + d1 * d1 * i11 + d2 * d2 * i22
            + 2.0 * (d0 * d1 * i01 + d0 * d2 * i02 + d1 * d2 * i12)) / det


def merge3_plain(w, m0, m1, m2, c00, c01, c02, c11, c12, c22,
                 min_separation: float, max_out: int):
    """The kernel's pick loop in PyTorch ops over all particles at once,
    with the kernel's one-pass moments centred on the pick."""
    P, K = w.shape
    means = (m0, m1, m2)
    covs = (c00, c01, c02, c11, c12, c22)
    out = [w.new_zeros((P, max_out)) for _ in range(10)]
    for q in (4, 7, 9):                              # c00, c11, c22
        out[q].fill_(1.0)
    w_rem = w.clone()
    col = torch.arange(K, device=w.device)
    for i in range(max_out):
        pick = torch.argmax(w_rem, dim=1, keepdim=True)       # first max
        mval = torch.gather(w_rem, 1, pick)
        if not bool((mval > 0.0).any()):
            break
        take = lambda a: torch.gather(a, 1, pick)
        rm = [take(m) for m in means]
        a = [0.5 * (take(c) + c) for c in covs]
        d = [r - m for r, m in zip(rm, means)]
        dist = mahalanobis3(a, d)
        sel = ((dist < min_separation) & (w_rem > 0.0)) \
            | (col[None, :] == pick)
        sel = sel & (mval > 0.0)
        sw = torch.where(sel, w_rem, 0.0)
        wsum = sw.sum(1)
        live = wsum > 0.0
        inv = torch.where(live, 1.0 / torch.clamp(wsum, min=1e-38), 0.0)
        mc = [(sw * dk).sum(1) * inv for dk in d]
        out[0][:, i] = wsum
        for k in range(3):
            out[1 + k][:, i] = torch.where(live, rm[k][:, 0] - mc[k], 0.0)
        for q, (x, y) in enumerate(PAIRS):
            n = (sw * (covs[q] + d[x] * d[y])).sum(1) * inv - mc[x] * mc[y]
            out[4 + q][:, i] = torch.where(live, n, 1.0) if x == y else n
        w_rem = torch.where(sel, 0.0, w_rem)
    return tuple(out)


def merge3_cuda(w, m0, m1, m2, c00, c01, c02, c11, c12, c22,
                min_separation: float, max_out: int):
    """Launch ``csrc/merge3.cu`` on PyTorch's current stream."""
    global launches
    chans = (w, m0, m1, m2, c00, c01, c02, c11, c12, c22)
    P, K = w.shape
    dev = w.device
    for c in chans:
        _build.check_tensor(c, (P, K), dev, "merge3 channel")
    if max_out < 1:
        raise ValueError(f"max_out must be at least 1, got {max_out}")
    lib, _ = _build.library()
    outs = [torch.empty((P, max_out), dtype=torch.float32, device=dev)
            for _ in range(10)]
    scratch = _build.scratch(lib.phd_merge3_wide_floats(P, K), dev)
    err = lib.phd_merge3_launch(
        *(c.data_ptr() for c in chans), *(o.data_ptr() for o in outs),
        P, K, max_out, float(min_separation), _build.ptr(scratch),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "merge3 kernel")
    launches += 1
    return tuple(outs)

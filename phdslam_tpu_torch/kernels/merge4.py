"""Kernel 6: greedy moment-matching merge of the 4-D candidate pool (the
dynamic map of the mixed model).

Replaces ``phdslam_tpu/kernels/merge_pallas.py::greedy_merge4_pallas``.
``merge4_cuda`` launches ``csrc/merge4.cu``; ``merge4_plain`` is the same
pick loop in plain PyTorch. ``filter/update4.py::greedy_merge4`` runs the
first on CUDA tensors and the second on CPU tensors. Both take ``w [P, K]``,
``mean [P, 4, K]`` and ``cov [P, 10, K]`` (the S4 order) and return
``w [P, cap]``, ``mean [P, 4, cap]`` and ``cov [P, 10, cap]``; empty slots
hold w = 0, mean 0 and the identity covariance.
"""

from __future__ import annotations

import torch

from phdslam_tpu_torch.kernels import _build
from phdslam_tpu_torch.ops.linalg import chol4_quad

DIAG = (0, 4, 7, 9)              # S4 channels of the diagonal
PAIRS = [(x, y) for x in range(4) for y in range(x, 4)]   # the S4 order

#: kernel launches since the count was last set to 0
launches = 0


def merge4_plain(w, mean, cov, min_separation: float, max_out: int):
    """The kernel's pick loop in PyTorch ops over all particles at once,
    with the kernel's one-pass moments centred on the pick."""
    P, K = w.shape
    ow = w.new_zeros((P, max_out))
    om = w.new_zeros((P, 4, max_out))
    oc = w.new_zeros((P, 10, max_out))
    oc[:, list(DIAG)] = 1.0
    means = [mean[:, k] for k in range(4)]
    covs = [cov[:, q] for q in range(10)]
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
        dist = chol4_quad(a, d)
        sel = ((dist < min_separation) & (w_rem > 0.0)) \
            | (col[None, :] == pick)
        sel = sel & (mval > 0.0)
        sw = torch.where(sel, w_rem, 0.0)
        wsum = sw.sum(1)
        live = wsum > 0.0
        inv = torch.where(live, 1.0 / torch.clamp(wsum, min=1e-38), 0.0)
        mc = [(sw * dk).sum(1) * inv for dk in d]
        ow[:, i] = wsum
        for k in range(4):
            om[:, k, i] = torch.where(live, rm[k][:, 0] - mc[k], 0.0)
        for q, (x, y) in enumerate(PAIRS):
            n = (sw * (covs[q] + d[x] * d[y])).sum(1) * inv - mc[x] * mc[y]
            oc[:, q, i] = torch.where(live, n, 1.0) if x == y else n
        w_rem = torch.where(sel, 0.0, w_rem)
    return ow, om, oc


def merge4_cuda(w, mean, cov, min_separation: float, max_out: int):
    """Launch ``csrc/merge4.cu`` on PyTorch's current stream."""
    global launches
    P, K = w.shape
    dev = w.device
    _build.check_tensor(w, (P, K), dev, "w")
    _build.check_tensor(mean, (P, 4, K), dev, "mean")
    _build.check_tensor(cov, (P, 10, K), dev, "cov")
    if max_out < 1:
        raise ValueError(f"max_out must be at least 1, got {max_out}")
    lib, _ = _build.library()
    ow = torch.empty((P, max_out), dtype=torch.float32, device=dev)
    om = torch.empty((P, 4, max_out), dtype=torch.float32, device=dev)
    oc = torch.empty((P, 10, max_out), dtype=torch.float32, device=dev)
    err = lib.phd_merge4_launch(
        w.data_ptr(), mean.data_ptr(), cov.data_ptr(), ow.data_ptr(),
        om.data_ptr(), oc.data_ptr(), P, K, max_out, float(min_separation),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "merge4 kernel")
    launches += 1
    return ow, om, oc

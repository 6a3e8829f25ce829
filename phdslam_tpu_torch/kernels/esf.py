"""Kernel 8: log elementary symmetric functions (ESF) of the CPHD update,
for the full measurement set and for every set with one measurement deleted.

Replaces ``phdslam_tpu/kernels/esf_pallas.py::esf_all_pallas``.
``esf_all_cuda`` launches ``csrc/esf.cu``; ``esf_all_plain`` is what the TPU
kernel computes, in plain PyTorch: ``filter/cphd.py``'s ``esf_log`` and
``esf_deleted`` with the input clamped at the sentinel -1e30 (for -inf) and
``logaddexp(a, b) = max + log1p(exp(min - max))``. ``esf_all`` runs the
first on CUDA tensors and the second on CPU tensors. Both take
``log_lambda [P, M]`` and return ``esf [P, M + 1]`` and ``esfd [P, M, M]``,
``esfd[p, m, k]`` = e_k of the set without measurement m. Empty
coefficients come back near -1e30 where ``esf_log`` has -inf: both are 0
after ``exp``.
"""

from __future__ import annotations

import torch

from phdslam_tpu_torch.kernels import _build

SENTINEL = -1e30

#: kernel launches since the count was last set to 0
launches = 0


def logaddexp_finite(a, b):
    """logaddexp for finite inputs (the sentinel, never -inf or NaN)."""
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    return mx + torch.log1p(torch.exp(mn - mx))


def esf_all_plain(log_lambda):
    """All M + 1 lanes (M deleted sets, then the full set) built up together
    over the M measurements, every coefficient updated at every step."""
    P, M = log_lambda.shape
    ll = torch.clamp(log_lambda, min=SENTINEL)
    lane = torch.arange(M + 1, device=ll.device)
    e = ll.new_full((P, M + 1, M + 1), SENTINEL)
    e[:, :, 0] = 0.0
    pad = ll.new_full((P, M + 1, 1), SENTINEL)
    for j in range(M):
        val = torch.where(lane == j, SENTINEL, ll[:, j, None])    # [P, M+1]
        shifted = torch.cat([pad, e[:, :, :-1]], dim=-1)
        e = logaddexp_finite(e, val[:, :, None] + shifted)
    return e[:, M].contiguous(), e[:, :M, :M].contiguous()


def esf_all_cuda(log_lambda):
    """Launch ``csrc/esf.cu`` on PyTorch's current stream."""
    global launches
    P, M = log_lambda.shape
    dev = log_lambda.device
    _build.check_tensor(log_lambda, (P, M), dev, "log_lambda")
    if M < 1:
        raise ValueError("esf kernel needs at least one measurement slot")
    lib, _ = _build.library()
    esf = torch.empty((P, M + 1), dtype=torch.float32, device=dev)
    esfd = torch.empty((P, M, M), dtype=torch.float32, device=dev)
    err = lib.phd_esf_launch(log_lambda.data_ptr(), esf.data_ptr(),
                             esfd.data_ptr(), P, M,
                             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "esf kernel")
    launches += 1
    return esf, esfd


def esf_all(log_lambda):
    """(esf, esfd) of log_lambda [P, M]: the kernel on a CUDA tensor, its
    plain version on a CPU tensor."""
    run = _build.kernel_for(log_lambda.device, esf_all_cuda, esf_all_plain,
                            "esf")
    return run(log_lambda.contiguous())

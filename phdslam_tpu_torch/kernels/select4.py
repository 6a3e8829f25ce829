"""Kernels 3 and 4: raw likelihood, normaliser and top-k1 selection of the
4-D dynamic map (the mixed static + dynamic model).

Replaces ``phdslam_tpu/kernels/preupdate_pallas.py::fused_update_select4``
and its index mode ``fused_update_select4_by_index``; both run
``csrc/select4.cu``, the second with ``by_index = 1``. The wrappers launch
the kernel on CUDA tensors (``select4_cuda``) and run ``select4_plain`` on
CPU tensors. Like the TPU kernel, every measurement column is computed and
the values are raw (unnormalised, unpruned): the caller masks the columns
and applies its normaliser. Outputs: ``sum_exp [P, M]``, ``w [P, M, k1]``
and either ``mean [P, 4, M, k1]`` and ``cov [P, 10, M, k1]`` (the updated
means and covariances of the picks) or ``idx [P, M, k1]`` int32 (0 where
w = 0).
"""

from __future__ import annotations

import torch

from phdslam_tpu_torch.kernels import _build
from phdslam_tpu_torch.kernels.select import (N_LOOP, _wrap_round,
                                              likelihoods, loop_lpw, top_k1)

#: launches of the payload kernel since the count was last set to 0
launches = 0
#: launches of the by-index kernel since the count was last set to 0
launches_by_index = 0


def select4_channels(pre4, gm4):
    """(the seven [P, F] loop channels, gain [P, 8, F], mean [P, 4, F],
    cov_update [P, 10, F])."""
    loop = [pre4.r, pre4.bearing, loop_lpw(pre4, gm4), pre4.si00, pre4.si01,
            pre4.si11, pre4.log_det_s]
    return loop, pre4.gain, gm4.mean_channels, pre4.cov_update


def select4_plain(loop, gain, mean, cov, z, *, k1: int,
                  by_index: bool = False):
    """The kernel's function in PyTorch ops. By index, gain, mean and cov
    are not read (they may be None)."""
    e, _ = likelihoods(loop, z)
    s = e.sum(-1)                                             # [P, M]
    w_sel, f_sel = top_k1(e, k1)
    del e
    if by_index:
        return s, w_sel, torch.where(w_sel > 0.0, f_sel, 0).to(torch.int32)
    r, b = loop[:2]
    P, F = r.shape
    M = z.shape[0]
    take = lambda a: torch.gather(a[:, None, :].expand(P, M, F), 2, f_sel)

    def takec(a):                       # [P, C, F] -> [P, C, M, k1]
        C = a.shape[1]
        return torch.gather(a[:, :, None, :].expand(P, C, M, F), 3,
                            f_sel[:, None].expand(P, C, M, k1))

    ir = z[None, :, None, 0] - take(r)
    ib = _wrap_round(z[None, :, None, 1] - take(b))
    gk = takec(gain)
    mf = takec(mean)
    mean_sel = torch.stack([mf[:, i] + gk[:, 2 * i] * ir
                            + gk[:, 2 * i + 1] * ib for i in range(4)], 1)
    return s, w_sel, mean_sel, takec(cov)


def select4_cuda(loop, gain, mean, cov, z, *, k1: int,
                 by_index: bool = False):
    """Launch ``csrc/select4.cu`` on PyTorch's current stream."""
    global launches, launches_by_index
    r = loop[0]
    P, F = r.shape
    M = z.shape[0]
    dev = r.device
    if len(loop) != N_LOOP:
        raise ValueError(f"select4 kernel takes {N_LOOP} loop channels, got "
                         f"{len(loop)}")
    for c in loop:
        _build.check_tensor(c, (P, F), dev, "channel")
    _build.check_tensor(z, (M, 2), dev, "z")
    if not 1 <= k1 <= 32:
        raise ValueError(f"k1 must be in [1, 32], got {k1}")
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    sum_exp, w_sel = f32(P, M), f32(P, M, k1)
    if by_index:
        idx = torch.empty((P, M, k1), dtype=torch.int32, device=dev)
        ptrs_in, ptrs_out = [None] * 3, [None, None, idx.data_ptr()]
    else:
        for t, c, name in ((gain, 8, "gain"), (mean, 4, "mean"),
                           (cov, 10, "cov")):
            _build.check_tensor(t, (P, c, F), dev, name)
        mean_sel, cov_sel = f32(P, 4, M, k1), f32(P, 10, M, k1)
        ptrs_in = [gain.data_ptr(), mean.data_ptr(), cov.data_ptr()]
        ptrs_out = [mean_sel.data_ptr(), cov_sel.data_ptr(), None]
    lib, _ = _build.library()
    err = lib.phd_select4_launch(
        *(c.data_ptr() for c in loop), *ptrs_in, z.data_ptr(),
        sum_exp.data_ptr(), w_sel.data_ptr(), *ptrs_out, P, F, M, k1,
        int(by_index), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "select4 kernel")
    if by_index:
        launches_by_index += 1
        return sum_exp, w_sel, idx
    launches += 1
    return sum_exp, w_sel, mean_sel, cov_sel


def _select4(z_rb, pre4, gm4, k1, by_index):
    loop, gain, mean, cov = select4_channels(pre4, gm4)
    run = _build.kernel_for(z_rb.device, select4_cuda, select4_plain,
                            "select4")
    return run([c.contiguous() for c in loop], gain.contiguous(),
               mean.contiguous(), cov.contiguous(), z_rb.contiguous(), k1=k1,
               by_index=by_index)


def fused_update_select4(z_rb, pre4, gm4, k1: int = 8):
    """Counterpart of the JAX wrapper: (sum_exp [P, M], w_sel [P, M, k1],
    mean_sel [P, 4, M, k1], cov_sel [P, 10, M, k1]), raw values."""
    return _select4(z_rb, pre4, gm4, k1, False)


def fused_update_select4_by_index(z_rb, pre4, gm4, k1: int = 8):
    """Counterpart of the JAX wrapper: (sum_exp, w_sel, idx_sel int32); the
    caller gathers the payload (``filter/update4.gather_selected4``)."""
    return _select4(z_rb, pre4, gm4, k1, True)

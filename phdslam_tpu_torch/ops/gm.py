"""Gaussian-mixture operations of ``phdslam_tpu/ops/gm.py``: the 2-D and
3-D greedy merge entry points, the fast-mode prune, and the top-k of
mixture weights with ``jax.lax.top_k``'s order."""

from __future__ import annotations

import torch

from phdslam_tpu_torch.kernels import _build, merge, merge3


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, the lower index first among equal values (a stable descending
    sort; ``torch.topk`` promises no order for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def fast_prune_renormalize(w, min_weight):
    """merge_mode 1: zero candidates below min_weight and scale the rest so
    each row keeps its total mass. w [..., K]."""
    total = w.sum(-1, keepdim=True)
    kept = torch.where(w >= min_weight, w, 0.0)
    ksum = kept.sum(-1, keepdim=True)
    scale = torch.where(ksum > 0, total / torch.clamp(ksum, min=1e-30), 0.0)
    return kept * scale


def greedy_merge_channels(w, mx, my, c00, c01, c11, min_separation,
                          max_out: int, metric: int = 0):
    """Greedy max-weight-first moment-matched merge of [P, K] channels into
    six [P, max_out] channels: the merge kernel on CUDA tensors, its plain
    version on CPU tensors."""
    if metric not in (0, 1):
        raise ValueError(f"distance_metric must be 0 or 1, got {metric}")
    run = _build.kernel_for(w.device, merge.merge_cuda, merge.merge_plain,
                            "merge")
    return run(*(c.contiguous() for c in (w, mx, my, c00, c01, c11)),
               float(min_separation), max_out, metric)


def greedy_merge_channels3(w, m0, m1, m2, c00, c01, c02, c11, c12, c22,
                           min_separation, max_out: int):
    """3-D greedy merge of [P, K] channels (disparity-space Gaussians: w,
    mean m0..m2, covariance c00, c01, c02, c11, c12, c22) into ten
    [P, max_out] channels: the merge3 kernel on CUDA tensors, its plain
    version on CPU tensors."""
    run = _build.kernel_for(w.device, merge3.merge3_cuda,
                            merge3.merge3_plain, "merge3")
    return run(*(c.contiguous() for c in (w, m0, m1, m2, c00, c01, c02, c11,
                                          c12, c22)),
               float(min_separation), max_out)

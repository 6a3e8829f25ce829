"""Gaussian-mixture operations of ``phdslam_tpu/ops/gm.py`` on the static
path: the greedy merge entry point and the fast-mode prune."""

from __future__ import annotations

import torch

from phdslam_tpu_torch.kernels import merge


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
    if w.device.type == "cuda":
        run = merge.merge_cuda
    elif w.device.type == "cpu":
        run = merge.merge_plain
    else:
        raise ValueError(f"no merge kernel for device {w.device}")
    return run(*(c.contiguous() for c in (w, mx, my, c00, c01, c11)),
               float(min_separation), max_out, metric)

"""Stratified resampling (``phdslam_tpu/ops/resample.py``) with the
uniforms passed in."""

from __future__ import annotations

import torch


def stratified_resample_indices(log_weights, u, n_out: int):
    """int32 indices [n_out]: slot j takes position (j + u_j) / n_out in the
    cumulative weights. An index past the end (weights that do not sum to
    exactly 1 in float32) becomes the maximum-weight particle."""
    n = log_weights.shape[0]
    csum = torch.cumsum(torch.exp(log_weights), 0)
    r = (torch.arange(n_out, dtype=log_weights.dtype,
                      device=log_weights.device) + u) / float(n_out)
    idx = torch.searchsorted(csum, r, side="left").to(torch.int32)
    max_idx = torch.argmax(log_weights).to(torch.int32)
    return torch.where(idx >= n, max_idx, idx)


def neff(log_weights):
    """Normalized effective sample size 1 / sum(w^2) / N."""
    n = log_weights.shape[0]
    return 1.0 / torch.sum(torch.exp(2.0 * log_weights)) / n

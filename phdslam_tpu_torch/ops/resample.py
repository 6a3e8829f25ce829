"""Stratified resampling (``phdslam_tpu/ops/resample.py``) with the
uniforms passed in, over one run's particles or over each of R runs
(``filter/runs.py``'s blockwise layout)."""

from __future__ import annotations

import torch


def stratified_resample_indices(log_weights, u, n_out: int, n_runs=None):
    """int32 indices [n_out] (R n_out with ``n_runs = R``): run r's slot j
    takes position (j + u_j) / n_out in the run's cumulative weights. An
    index past the end (weights that do not sum to exactly 1 in float32)
    becomes the run's maximum-weight particle. Run r's indices are offset
    by r n, n its particles in ``log_weights``."""
    R = n_runs or 1
    lw = log_weights.reshape(R, -1)
    n = lw.shape[1]
    csum = torch.cumsum(torch.exp(lw), 1)
    r = (torch.arange(n_out, dtype=lw.dtype, device=lw.device)
         + u.reshape(R, n_out)) / float(n_out)
    idx = torch.searchsorted(csum, r, side="left").to(torch.int32)
    max_idx = torch.argmax(lw, 1, keepdim=True).to(torch.int32)
    idx = torch.where(idx >= n, max_idx, idx)
    if n_runs is None:
        return idx[0]
    off = torch.arange(R, dtype=torch.int32, device=lw.device) * n
    return (idx + off[:, None]).reshape(-1)


def neff(log_weights, n_runs=None):
    """Normalized effective sample size 1 / sum(w^2) / N, of one run (a
    scalar) or of each of R runs ([R])."""
    lw = log_weights if n_runs is None else log_weights.reshape(n_runs, -1)
    n = lw.shape[-1]
    return 1.0 / torch.sum(torch.exp(2.0 * lw), -1) / n

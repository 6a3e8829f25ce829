"""Stratified resampling (``phdslam_tpu/ops/resample.py``) with the
uniforms passed in, over one run's particles or over each of R runs
(``filter/runs.py``'s blockwise layout).

``layout_runs``: torch's CUDA reductions and scans choose their thread
layout by the row count, so one run's sum or cumulative sum rounds
otherwise among 2 runs than among 8 (and a single row takes another scan
altogether). A caller that holds R of L runs (the island step across
ranks: n/W of n islands) passes L, and each per-run reduction is taken
over the rows repeated to L and cut back to R (``among``): each run then
rounds as it does among all L on one device. On the CPU every row rounds
alike at any count.

One run's cumulative weights are scanned as the first of two rows: torch
takes a single row's CUDA cumsum through CUB's device scan, whose float
sums depend on the order its tiles finish (from 32,768 weights on an H100
two calls on the same inputs can differ, at 65,536 a resample fired on
the same weights picks other particles), while each row of a multi-row
cumsum is one ordered block scan."""

from __future__ import annotations

import torch


def among(fn, x, layout_runs=None):
    """fn (one value per row of a [L, ...] tensor, along dim 0) on x's R
    rows as torch computes it among ``layout_runs`` = L rows (a multiple
    of R): x repeated to L rows, the result cut back to its first R."""
    R = x.shape[0]
    if layout_runs is None or layout_runs == R:
        return fn(x)
    if layout_runs % R:
        raise ValueError(f"layout_runs {layout_runs} is not a multiple of "
                         f"the {R} runs held")
    return fn(x.repeat(layout_runs // R, *([1] * (x.dim() - 1))))[:R]


def stratified_resample_indices(log_weights, u, n_out: int, n_runs=None,
                                layout_runs=None):
    """int32 indices [n_out] (R n_out with ``n_runs = R``): run r's slot j
    takes position (j + u_j) / n_out in the run's cumulative weights. An
    index past the end (weights that do not sum to exactly 1 in float32)
    becomes the run's maximum-weight particle. Run r's indices are offset
    by r n, n its particles in ``log_weights``."""
    R = n_runs or 1
    lw = log_weights.reshape(R, -1)
    n = lw.shape[1]
    # one run as the first of two rows: never a single-row scan
    csum = among(lambda w: torch.cumsum(w, 1), torch.exp(lw),
                 layout_runs or (2 if R == 1 else None))
    r = (torch.arange(n_out, dtype=lw.dtype, device=lw.device)
         + u.reshape(R, n_out)) / float(n_out)
    idx = torch.searchsorted(csum, r, side="left").to(torch.int32)
    max_idx = torch.argmax(lw, 1, keepdim=True).to(torch.int32)
    idx = torch.where(idx >= n, max_idx, idx)
    if n_runs is None:
        return idx[0]
    off = torch.arange(R, dtype=torch.int32, device=lw.device) * n
    return (idx + off[:, None]).reshape(-1)


def neff(log_weights, n_runs=None, layout_runs=None):
    """Normalized effective sample size 1 / sum(w^2) / N, of one run (a
    scalar) or of each of R runs ([R])."""
    if n_runs is None:
        lw = log_weights
        return 1.0 / torch.sum(torch.exp(2.0 * lw), -1) / lw.shape[-1]
    lw = log_weights.reshape(n_runs, -1)
    return 1.0 / among(lambda v: torch.sum(torch.exp(2.0 * v), -1), lw,
                       layout_runs) / lw.shape[-1]

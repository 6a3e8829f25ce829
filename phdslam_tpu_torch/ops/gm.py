"""Gaussian-mixture operations of ``phdslam_tpu/ops/gm.py``: the 2-D and
3-D greedy merge entry points, the fast-mode prune, the top-k of mixture
weights with ``jax.lax.top_k``'s order, and the host-side greedy reduction
of the EAP map (NumPy, ``reduce_mixture_np``)."""

from __future__ import annotations

import numpy as np
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


def _mahalanobis_sq(mean_h, cov_h, mean, cov):
    """The reduction's distance of the head (mean_h, cov_h) to each
    candidate: with L the Cholesky factor of the averaged covariance,
    |L^-1 (mean_h - mean)|^2, inf where the average is not positive
    definite. The LAPACK calls are those of one pair at a time, batched."""
    sigma = 0.5 * (cov_h[None] + cov)
    diff = mean_h[None] - mean
    try:
        x = np.linalg.solve(np.linalg.cholesky(sigma), diff[..., None])
        return np.einsum("ni,ni->n", x[..., 0], x[..., 0])
    except np.linalg.LinAlgError:      # some average is not PD: pair by pair
        out = np.empty(len(mean))
        for k in range(len(mean)):
            try:
                xk = np.linalg.solve(np.linalg.cholesky(sigma[k]), diff[k])
                out[k] = float(np.dot(xk, xk))
            except np.linalg.LinAlgError:
                out[k] = np.inf
        return out


def reduce_mixture_np(w, mean, cov, min_separation):
    """NumPy greedy reduction with the reference CPU reducer's semantics
    (``phdslam_tpu/ops/gm.py::reduce_mixture_np``): sort by weight once
    (stable), take the first unused component as the head, merge every
    unused component within the Mahalanobis distance of the averaged
    covariance (Cholesky L-solve form) into it, repeat. Each head's
    distances are computed for all unused components at once. Used for
    the EAP map on the host.

    Returns (w_out, mean_out, cov_out) as numpy arrays (dynamic length,
    host-side only).
    """
    w = np.asarray(w, np.float64)
    mean = np.asarray(mean, np.float64)
    cov = np.asarray(cov, np.float64)
    order = np.argsort(-w, kind="stable")
    left = order[w[order] > 0]              # unused, in weight order
    out_w, out_m, out_c = [], [], []
    while len(left):
        head, rest = left[0], left[1:]
        near = _mahalanobis_sq(mean[head], cov[head], mean[rest],
                               cov[rest]) < min_separation
        members = np.concatenate([[head], rest[near]])
        left = rest[~near]
        mw = w[members]
        wsum = mw.sum()
        mu = (mw[:, None] * mean[members]).sum(0) / wsum
        diffs = mu[None] - mean[members]
        sig = (mw[:, None, None]
               * (cov[members] + diffs[:, :, None] * diffs[:, None, :])
               ).sum(0) / wsum
        out_w.append(wsum)
        out_m.append(mu)
        out_c.append(sig)
    if not out_w:
        d = mean.shape[-1]
        return (np.zeros((0,)), np.zeros((0, d)), np.zeros((0, d, d)))
    return np.array(out_w), np.array(out_m), np.array(out_c)

"""Gaussian-mixture operations of ``phdslam_tpu/ops/gm.py``: the 2-D and
3-D greedy merge entry points, their array-of-structs forms
(``greedy_merge``, ``greedy_merge_batch``), the prunes, the top-k of
mixture weights with ``jax.lax.top_k``'s order, the mixture's intensity,
and the host-side greedy reduction of the EAP map (NumPy,
``reduce_mixture_np``)."""

from __future__ import annotations

import numpy as np
import torch

from phdslam_tpu_torch.kernels import _build, merge, merge3
from phdslam_tpu_torch.ops.linalg import (gaussian_logpdf, hellinger_gaussian,
                                          mahalanobis_gaussian, symmetrize)


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, the lower index first among equal values (a stable descending
    sort; ``torch.topk`` promises no order for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_components(w, mean, cov, k: int):
    """The k highest-weight components of a padded mixture (empty slots,
    w = 0, sort last): w [..., N], mean [..., N, d], cov [..., N, d, d] ->
    [..., k], [..., k, d], [..., k, d, d]."""
    top_w, idx = top_k(w, k)
    d = mean.shape[-1]
    mean_k = mean.gather(-2, idx[..., None].expand(*idx.shape, d))
    cov_k = cov.gather(-3, idx[..., None, None].expand(*idx.shape, d, d))
    return top_w, mean_k, cov_k


def prune_weights(w, min_weight):
    """Zero the weights below min_weight."""
    return torch.where(w >= min_weight, w, 0.0)


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


def greedy_merge(w, mean, cov, min_separation, max_out: int,
                 metric: int = 0):
    """Greedy max-weight-first moment-matched reduction of a padded mixture
    in array-of-structs form, any dimension d: w [..., N], mean [..., N,
    d], cov [..., N, d, d] -> (w [..., max_out], mean [..., max_out, d],
    cov [..., max_out, d, d]). Each round picks the heaviest unmerged
    component (the first among equals), merges every unmerged one within
    min_separation of it (Mahalanobis under the averaged covariance, or
    Hellinger with metric 1) and writes the moment-matched, symmetrised
    Gaussian. Exactly max_out rounds of tensor ops, so no round waits for
    the device; a mixture with nothing left writes w 0, mean 0 and an
    identity covariance, as the JAX loop leaves its unwritten outputs."""
    if metric not in (0, 1):
        raise ValueError(f"distance_metric must be 0 or 1, got {metric}")
    dist_of = hellinger_gaussian if metric == 1 else mahalanobis_gaussian
    n, d = mean.shape[-2], mean.shape[-1]
    col = torch.arange(n, device=w.device)
    eye = torch.eye(d, dtype=mean.dtype, device=mean.device)
    w_rem = w
    outs = [], [], []
    for _ in range(max_out):
        active = (w_rem > 0).any(-1)
        pick = torch.argmax(w_rem, -1, keepdim=True)
        ref_mean = mean.gather(-2, pick[..., None].expand(*pick.shape, d))
        ref_cov = cov.gather(-3, pick[..., None, None].expand(
            *pick.shape, d, d))
        sel = (dist_of(ref_mean, ref_cov, mean, cov) < min_separation) \
            & (w_rem > 0)
        sel = (sel | (col == pick)) & active[..., None]
        sw = torch.where(sel, w_rem, 0.0)
        wsum = sw.sum(-1)
        div = torch.where(active, wsum, 1.0)
        mu = (sw[..., None] * mean).sum(-2) / div[..., None]
        diff = mu[..., None, :] - mean
        outer = diff[..., :, None] * diff[..., None, :]
        sig = symmetrize((sw[..., None, None] * (cov + outer)).sum(-3)
                         / div[..., None, None])
        outs[0].append(wsum)
        outs[1].append(torch.where(active[..., None], mu, 0.0))
        outs[2].append(torch.where(active[..., None, None], sig, eye))
        w_rem = torch.where(sel, 0.0, w_rem)
    return (torch.stack(outs[0], -1), torch.stack(outs[1], -2),
            torch.stack(outs[2], -3))


def greedy_merge_batch(w, mean, cov, min_separation, max_out: int,
                       metric: int = 0):
    """``greedy_merge`` over the channel cores: for d = 2 (metrics 0 and 1)
    ``greedy_merge_channels`` and for d = 3 (metric 0)
    ``greedy_merge_channels3``, so a CUDA tensor reaches the merge or
    merge3 kernel; the off-diagonals are averaged into one channel. Any
    other d or metric runs ``greedy_merge``. Leading dims [...] of w
    [..., K] flatten to the kernels' particle axis."""
    d = mean.shape[-1]
    if d not in (2, 3) or (d == 3 and metric != 0):
        return greedy_merge(w, mean, cov, min_separation, max_out, metric)
    lead, k = w.shape[:-1], w.shape[-1]
    flat = lambda a: a.reshape(-1, k)
    means = [flat(mean[..., i]) for i in range(d)]
    covs = [flat(cov[..., i, i]) if i == j
            else flat(0.5 * (cov[..., i, j] + cov[..., j, i]))
            for i in range(d) for j in range(i, d)]
    if d == 2:
        out = greedy_merge_channels(flat(w), *means, *covs, min_separation,
                                    max_out, metric)
    else:
        out = greedy_merge_channels3(flat(w), *means, *covs, min_separation,
                                     max_out)
    out = [o.reshape(*lead, max_out) for o in out]
    upper = iter(out[1 + d:])
    c = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i, d):
            c[i][j] = c[j][i] = next(upper)
    return (out[0], torch.stack(out[1:1 + d], -1),
            torch.stack([torch.stack(row, -1) for row in c], -2))


def eval_mixture(w, mean, cov, x):
    """The mixture's intensity at points x [..., d]: sum over components of
    w N(x; mean, cov)."""
    logpdf = gaussian_logpdf(x[..., None, :], mean, cov)
    return (w * torch.exp(logpdf)).sum(-1)


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

"""OSPA (Optimal SubPattern Assignment) metric: ``ospa_np``, the port's copy
of ``phdslam_tpu/ops/ospa.py::ospa_np`` on the host, with scipy's exact
Jonker-Volgenant assignment (the JAX package prefers its optional C++
solver when built; the optimum is the same); and ``ospa_torch``, the
counterpart of ``ospa_jax``: fixed-shape OSPA on the device with an
eps-scaled auction (``_auction_assign``, the kernel of
``kernels/auction.py::auction_square``).

  - swap so |X| = m <= n = |Y|
  - cost matrix of Euclidean distances, cut off at c before assignment
  - ospa = ((sum_assigned d^p + (n-m) c^p) / n)^(1/p)
    loc  = (sum_assigned d^p / n)^(1/p)
    card = ((n-m) c^p / n)^(1/p)
  - empty/empty -> (0, 0, 0); one empty -> (c, 0, c)
"""

from __future__ import annotations

import numpy as np
import torch

from phdslam_tpu_torch.kernels.auction import auction_square


def ospa_np(x, y, p: float = 1.0, c: float = 10.0):
    """Exact OSPA of x [m, d] and y [n, d]; returns (ospa, loc, card)."""
    from scipy.optimize import linear_sum_assignment

    x = np.atleast_2d(np.asarray(x, np.float64))
    y = np.atleast_2d(np.asarray(y, np.float64))
    m, n = x.shape[0], y.shape[0]
    if m == 0 and n == 0:
        return 0.0, 0.0, 0.0
    if m == 0 or n == 0:
        return float(c), 0.0, float(c)
    if m > n:
        x, y = y, x
        m, n = n, m
    d = np.linalg.norm(x[:, None, :] - y[None, :, :], axis=-1)
    d = np.minimum(d, c)
    rows, cols = linear_sum_assignment(d ** p)
    total_loc = float((d[rows, cols] ** p).sum())
    err_cn = (c ** p * (n - m) / n) ** (1.0 / p)
    err_loc = (total_loc / n) ** (1.0 / p)
    err = ((total_loc + (n - m) * c ** p) / n) ** (1.0 / p)
    return err, err_loc, err_cn


#: eps-optimality of the final scaling phase, in units of the (normalised
#: to [0, 1]) cost range: the auction ends with a total assignment cost
#: within n * _EPS_FINAL of the optimum, so OSPA's error is at most
#: _EPS_FINAL * c**p (5e-3 at p = 1, c = 5)
_EPS_FINAL = 1e-3
_THETA = 4.0     # eps reduction factor between scaling phases
#: per-phase round budget, in multiples of n
_BIDS_PER_N = 16


def eps_schedule(device=None):
    """The float32 eps of each scaling phase, largest first: _EPS_FINAL *
    _THETA ** k as Python floats, then cast, as JAX builds them."""
    n_phases = max(1, int(np.ceil(np.log(0.25 / _EPS_FINAL)
                                  / np.log(_THETA))) + 1)
    return torch.tensor(
        [_EPS_FINAL * _THETA ** (n_phases - 1 - k) for k in range(n_phases)],
        dtype=torch.float32, device=device)


def _auction_assign(cost, max_iters: int = 0):
    """Square min-cost assignment of cost [n, n] (entries in [0, 1]) by the
    Jacobi forward auction with eps-scaling: owner[j], the row assigned to
    column j (int32). ``max_iters`` caps each phase's rounds (0: 16 n);
    rows a capped phase leaves unassigned are paired with the unowned
    columns in index order, so the assignment is always complete."""
    n = cost.shape[0]
    budget = max_iters or _BIDS_PER_N * n
    owner, _ = auction_square(cost[None], eps_schedule(cost.device), budget)
    return owner[0]


def padded_cost(x, x_valid, y, y_valid, p: float = 1.0, c: float = 10.0):
    """The padded square problem of ``ospa_torch``: (d [n, n], the distances
    cut at c with every pair that involves a padded slot at exactly c; cost
    [n, n] = d**p / c**p, the auction's input), n = max(|x|, |y|)."""
    mx, my = x.shape[0], y.shape[0]
    n = max(mx, my)
    big_x = x.new_zeros((n, x.shape[1]))
    big_x[:mx] = x
    big_y = y.new_zeros((n, y.shape[1]))
    big_y[:my] = y
    vx = torch.zeros((n,), dtype=torch.bool, device=x.device)
    vx[:mx] = x_valid
    vy = torch.zeros((n,), dtype=torch.bool, device=y.device)
    vy[:my] = y_valid
    c_t = torch.tensor(c, dtype=x.dtype, device=x.device)
    d = torch.linalg.vector_norm(big_x[:, None, :] - big_y[None, :, :],
                                 dim=-1)
    d = torch.minimum(d, c_t)
    d = torch.where(vx[:, None] & vy[None, :], d, c_t)
    # a division by a 0-d tensor: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal
    cost = d ** p / torch.tensor(c ** p, dtype=x.dtype, device=x.device)
    return d, cost, vx, vy


def ospa_torch(x, x_valid, y, y_valid, p: float = 1.0, c: float = 10.0,
               max_iters: int = 0):
    """Fixed-shape OSPA on the tensors' device: x [Mx, d] with mask x_valid,
    y [My, d] with mask y_valid. Padded entries cost exactly c against
    everything, so they act as OSPA's (n - m) dummy points. Returns 0-d
    tensors (ospa, loc, card) on the inputs' device, without reading it.
    ``max_iters`` caps each eps phase's auction rounds (0: 16 n)."""
    d, cost, vx, vy = padded_cost(x, x_valid, y, y_valid, p, c)
    n = d.shape[0]
    owner = _auction_assign(cost, max_iters).long()
    cols = torch.arange(n, device=d.device)
    dtype = x.dtype
    sx, sy = vx.sum(), vy.sum()
    m_count = torch.minimum(sx, sy).to(dtype)
    n_count = torch.maximum(sx, sy).to(dtype)
    cp = torch.tensor(c ** p, dtype=dtype, device=d.device)
    # every padded-square pair but real-real costs exactly c^p, so the
    # localisation cost is the padded total less (n - m) c^p, whichever
    # optimum the auction picked
    total_pad = (d[owner, cols] ** p).sum()
    total_loc = torch.clamp_min(total_pad - (n - m_count) * cp, 0.0)
    n_safe = torch.clamp_min(n_count, 1.0)
    err = ((total_loc + (n_count - m_count) * cp) / n_safe) ** (1.0 / p)
    loc = (total_loc / n_safe) ** (1.0 / p)
    card = ((n_count - m_count) * cp / n_safe) ** (1.0 / p)
    # the empty-set conventions
    zero = torch.zeros((), dtype=dtype, device=d.device)
    c_t = torch.tensor(c, dtype=dtype, device=d.device)
    both_empty = (m_count == 0) & (n_count == 0)
    one_empty = (m_count == 0) & (n_count > 0)
    err = torch.where(both_empty, zero, torch.where(one_empty, c_t, err))
    loc = torch.where(both_empty | one_empty, zero, loc)
    card = torch.where(both_empty, zero, torch.where(one_empty, c_t, card))
    return err, loc, card

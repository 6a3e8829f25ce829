"""The two auctions: FastSLAM's joint association whole, and the in-loop
OSPA's square eps-scaled auction, each one kernel launch.

FastSLAM (``auction_assign``) replaces ``phdslam_tpu/filter/fastslam.py::
_auction_rows`` under ``jax.vmap`` (not a Pallas kernel): the clamp of the
gated-out pairs, the Jacobi forward auction's rounds (a ``lax.while_loop``
whose trip count depends on the data; a loop of PyTorch ops could end only
by reading a flag on the host every round) and the column readout.
``auction_assign_cuda`` runs all three in ``csrc/auction.cu``;
``auction_assign_plain`` is the same in PyTorch ops over all particles at
once: the private no-match columns concatenated, ``clamp_benefit``, the
rounds (``_rounds``, a particle frozen once it has finished, as JAX's
vmapped ``while_loop`` freezes it, reading the device every round), then
``col_of_row``. ``auction_assign`` runs the first on CUDA tensors and the
second on CPU tensors. They take the raw benefit ``[P, M, F]`` (float32,
gated-out pairs at ``NEG``), the private value (log kappa: column F + m
holds it for row m and ``NEG`` for every other row; the kernel never
materialises those columns) and the round budget, and return ``col [P,
M]`` int32, each row's column (F + m: no match), and ``iters [P]`` int32,
the rounds each particle ran.

A round: every unassigned row bids on the first column of its largest
``benefit - price`` (a NaN counts as the largest) the gap to its
second-largest value over the other columns (itself where that is not
finite) plus eps; a column whose largest bid is finite goes to the lowest
row among its largest bids, its price rising by the bid; the rounds end
when every row is assigned or at the budget. Nothing is multiplied in the
rounds and the clamp rounds as PyTorch does, so the kernel's columns and
rounds equal the plain version's bit for bit.

The same rounds run the square eps-scaled auction of the in-loop OSPA
(``ops/ospa.py::ospa_torch``), which replaces the ``lax.while_loop`` inside
a ``lax.scan`` over eps phases of ``phdslam_tpu/ops/ospa.py::
_auction_assign``: ``auction_square_cuda`` runs every phase and the
clean-up in one launch, one CTA per problem, the cost on chip up to n =
256; ``auction_square_plain`` is the same in PyTorch ops;
``auction_square`` picks one by the device. They take ``cost [B, n, n]``
(float32, in [0, 1]; the benefit is ``-cost``), the eps schedule ``eps
[n_phases]`` and a per-phase budget, and return ``owner [B, n]`` int32
(every column owned) and ``iters [B, n_phases]`` int32, the rounds of each
phase. Prices carry from one phase to the next; ownership restarts each
phase; after the last one the rows left unassigned take the columns left
unowned in index order.
"""

from __future__ import annotations

import torch

from phdslam_tpu_torch.kernels import _build

#: kernel launches since the count was last set to 0 (FastSLAM's
#: association; the square OSPA auction counts in ``launches_square``)
launches = 0
launches_square = 0

#: benefit of a gated-out or invalid pair: finite, so bids stay NaN-free
NEG = -1e30
#: the auction's eps, in units of the particle's live-benefit span
EPS_FINAL = 1e-3


def _check(benefit, budget):
    if benefit.dim() != 3:
        raise ValueError(f"auction: benefit must be [P, M, F], got "
                         f"{tuple(benefit.shape)}")
    if not 0 <= budget < 2 ** 31:
        raise ValueError(f"auction: budget {budget} out of range")
    return benefit.shape


def _rounds(benefit, eps, budget: int, price):
    """The rounds from the given prices, all particles at once: (owner,
    iters, price, assigned, bids), bids the rows that bid, summed over the
    rounds (a measure of the work, for the bounds)."""
    P, M, C = benefit.shape
    dev = benefit.device
    cols = torch.arange(C, device=dev)
    rows = torch.arange(M, device=dev)
    neg_inf = float("-inf")
    owner = torch.full((P, C), -1, dtype=torch.int32, device=dev)
    assigned = torch.zeros((P, M), dtype=torch.bool, device=dev)
    iters = torch.zeros((P,), dtype=torch.int32, device=dev)
    bids = torch.zeros((P,), dtype=torch.int64, device=dev)
    active = ~assigned.all(1) & (iters < budget)
    while bool(active.any()):
        values = benefit - price[:, None, :]
        first = (values == values.amax(2, keepdim=True)) | values.isnan()
        j_best = torch.where(first, cols, C).amin(2, keepdim=True)
        v_best = values.gather(2, j_best)[..., 0]
        v_second = values.scatter(2, j_best, neg_inf).amax(2)
        v_second = torch.where(v_second.isfinite(), v_second, v_best)
        bid = (v_best - v_second) + eps[:, None]
        bidding = ~assigned & active[:, None]
        bids += bidding.sum(1)
        bid_mat = torch.where(bidding[..., None] & (j_best == cols),
                              bid[..., None], neg_inf)          # [P, M, C]
        col_bid = bid_mat.amax(1)
        col_bidder = torch.where(bid_mat == col_bid[:, None, :],
                                 rows[:, None], M).amin(1)
        win = col_bid.isfinite()
        price = torch.where(win, price + col_bid, price)
        owner = torch.where(win, col_bidder.to(torch.int32), owner)
        held = torch.where(owner >= 0, owner, M).long()
        assigned = torch.zeros((P, M + 1), dtype=torch.bool,
                               device=dev).scatter_(1, held, True)[:, :M]
        iters += active.to(torch.int32)
        active = active & ~assigned.all(1) & (iters < budget)
    return owner, iters, price, assigned, bids


def clamp_benefit(benefit):
    """Per particle of benefit [P, M, C]: gated-out pairs (at NEG) raised
    to a floor 4 spans below the lowest live value, so prices stay within a
    few spans. Returns (clamped benefit, eps [P], live mask)."""
    live = benefit > NEG / 2
    hi = torch.where(live, benefit, float("-inf")).amax((1, 2))
    lo = torch.where(live, benefit, float("inf")).amin((1, 2))
    hi = torch.where(hi.isfinite(), hi, 0.0)     # degenerate: nothing live
    lo = torch.where(lo.isfinite(), lo, 0.0)
    span = torch.clamp(hi - lo, min=1.0)
    floor = lo - 4.0 * span - 1.0
    return (torch.where(live, benefit, floor[:, None, None]),
            EPS_FINAL * span, live)


def col_of_row(owner, clamped, live):
    """Each row's column [P, M]: the lowest column it owns, or, for a row
    left unassigned at the budget, its best column among those only it can
    win (with the private no-match columns, column F + m)."""
    P, M, C = clamped.shape
    cols = torch.arange(C, device=owner.device).expand(P, C)
    held = torch.where(owner >= 0, owner, M).long()
    col = torch.full((P, M + 1), C, dtype=torch.long, device=owner.device)
    col = col.scatter_reduce(1, held, cols, "amin")[:, :M]
    alone = live & (live.sum(1, keepdim=True) == 1)
    private = torch.where(alone, clamped, float("-inf"))
    return torch.where(col < C, col, private.argmax(2))


def auction_assign_plain(benefit, private_value: float, budget: int):
    """The kernel's clamp, rounds and readout in PyTorch ops, all particles
    at once; a particle stops changing once every row is assigned or its
    budget is spent."""
    P, M, F = _check(benefit, budget)
    if P == 0 or M == 0:
        return (torch.empty((P, M), dtype=torch.int32, device=benefit.device),
                torch.zeros((P,), dtype=torch.int32, device=benefit.device))
    # the private no-match columns: column F + m holds private_value for
    # row m and NEG for the others (the tensor the kernel never makes)
    eye = torch.eye(M, dtype=torch.bool, device=benefit.device)
    dummy = torch.where(eye, private_value, NEG).to(benefit.dtype)
    full = torch.cat([benefit, dummy.expand(P, M, M)], dim=2)
    clamped, eps, live = clamp_benefit(full)
    owner, iters, _, _, _ = _rounds(clamped, eps, budget,
                                    clamped.new_zeros((P, F + M)))
    return col_of_row(owner, clamped, live).to(torch.int32), iters


def auction_assign_cuda(benefit, private_value: float, budget: int):
    """Launch FastSLAM's association in ``csrc/auction.cu`` on PyTorch's
    current stream: one CTA per particle, the state in shared memory (in
    device memory this wrapper allocates where C = F + M is in the tens of
    thousands), the benefit read from device memory."""
    global launches
    P, M, F = _check(benefit, budget)
    dev = benefit.device
    _build.check_tensor(benefit, (P, M, F), dev, "benefit")
    col = torch.empty((P, M), dtype=torch.int32, device=dev)
    iters = torch.empty((P,), dtype=torch.int32, device=dev)
    if P == 0 or M == 0:
        iters.zero_()
        return col, iters
    lib, _ = _build.library()
    scratch = _build.scratch(lib.phd_auction_wide_floats(P, M, F), dev)
    # ctypes rounds the private value to float32, as the plain version's
    # cast of its private columns does
    err = lib.phd_auction_launch(
        benefit.data_ptr(), col.data_ptr(), iters.data_ptr(), P, M, F,
        float(private_value), int(budget), _build.ptr(scratch),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "auction kernel")
    launches += 1
    return col, iters


def auction_assign(benefit, private_value: float, budget: int):
    """(col [P, M], iters [P]) of the raw benefit [P, M, F] with private
    no-match columns at private_value: the kernel on a CUDA tensor, its
    plain version on a CPU tensor."""
    run = _build.kernel_for(benefit.device, auction_assign_cuda,
                            auction_assign_plain, "auction")
    return run(benefit.contiguous(), private_value, budget)


# ------------------------------------------- the square OSPA auction --

def _check_square(cost, eps, budget):
    if cost.dim() != 3 or cost.shape[1] != cost.shape[2]:
        raise ValueError(f"square auction: cost must be [B, n, n], got "
                         f"{tuple(cost.shape)}")
    if eps.dim() != 1:
        raise ValueError("square auction: eps must be [n_phases]")
    if not 0 <= budget < 2 ** 31:
        raise ValueError(f"square auction: budget {budget} out of range")
    return cost.shape[0], cost.shape[1], eps.shape[0]


def square_plain_with_bids(cost, eps, budget: int):
    """``auction_square_plain``'s (owner, iters) and the bids made, summed
    over every phase's rounds, per problem [B] (for the bounds)."""
    B, n, K = _check_square(cost, eps, budget)
    dev = cost.device
    benefit = -cost
    price = cost.new_zeros((B, n))
    iters = torch.zeros((B, K), dtype=torch.int32, device=dev)
    bids = torch.zeros((B,), dtype=torch.int64, device=dev)
    owner = torch.full((B, n), -1, dtype=torch.int32, device=dev)
    assigned = torch.zeros((B, n), dtype=torch.bool, device=dev)
    for k in range(K):
        owner, it, price, assigned, b = _rounds(
            benefit, eps[k].expand(B), budget, price)
        iters[:, k] = it
        bids += b
    # the clean-up: the k-th unassigned row takes the k-th unowned column
    free = owner < 0
    col_rank = (free.long().cumsum(1) - 1).clamp(min=0)
    row_rank = torch.where(~assigned, (~assigned).long().cumsum(1) - 1, n)
    row_of_rank = torch.full((B, n + 1), -1, dtype=torch.int32, device=dev)
    row_of_rank.scatter_(1, row_rank, torch.arange(
        n, dtype=torch.int32, device=dev).expand(B, n).contiguous())
    owner = torch.where(free, row_of_rank.gather(1, col_rank), owner)
    return owner, iters, bids


def auction_square_plain(cost, eps, budget: int):
    """The square kernel's phases and clean-up in PyTorch ops, every
    problem at once (reading the device every round)."""
    owner, iters, _ = square_plain_with_bids(cost, eps, budget)
    return owner, iters


def auction_square_cuda(cost, eps, budget: int):
    """Launch the square auction of ``csrc/auction.cu`` on PyTorch's current
    stream: one CTA of up to 32 warps per problem, the cost in shared
    memory up to n = 237, in shared memory and registers up to n = 256, and
    read from device memory above."""
    global launches_square
    B, n, K = _check_square(cost, eps, budget)
    dev = cost.device
    _build.check_tensor(cost, (B, n, n), dev, "cost")
    _build.check_tensor(eps, (K,), dev, "eps")
    owner = torch.empty((B, n), dtype=torch.int32, device=dev)
    iters = torch.empty((B, K), dtype=torch.int32, device=dev)
    if B == 0 or n == 0:
        iters.zero_()
        return owner, iters
    lib, _ = _build.library()
    scratch = _build.scratch(lib.phd_auction_square_wide_floats(B, n), dev)
    err = lib.phd_auction_square_launch(
        cost.data_ptr(), eps.data_ptr(), owner.data_ptr(), iters.data_ptr(),
        B, n, K, int(budget), _build.ptr(scratch),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "square auction kernel")
    launches_square += 1
    return owner, iters


def auction_square(cost, eps, budget: int):
    """(owner [B, n], iters [B, n_phases]) of cost [B, n, n]: the kernel on
    a CUDA tensor, its plain version on a CPU tensor."""
    run = _build.kernel_for(cost.device, auction_square_cuda,
                            auction_square_plain, "square auction")
    return run(cost.contiguous(), eps.contiguous(), budget)

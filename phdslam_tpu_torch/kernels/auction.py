"""The FastSLAM auction: the rounds of the joint association's Jacobi
forward auction, every particle's inside one kernel launch.

Replaces the ``lax.while_loop`` of ``phdslam_tpu/filter/fastslam.py::
_auction_rows`` (not a Pallas kernel). Its trip count depends on the data;
a loop of PyTorch ops could end only by reading a flag on the host every
round, so the rounds run inside ``csrc/auction.cu``, as the merges keep
theirs. ``auction_rows_cuda`` launches it; ``auction_rows_plain`` is the
same rounds in PyTorch ops over all particles at once, a particle frozen
once it has finished (as JAX's vmapped ``while_loop`` freezes it), reading
the device every round. ``auction_rows`` runs the first on CUDA tensors
and the second on CPU tensors.

Both take the clamped benefit ``[P, M, C]`` (float32, finite where the
filter made it), ``eps [P]`` and the round budget, and return ``owner
[P, C]`` int32 (-1 for an unowned column) and ``iters [P]`` int32, the
rounds each particle ran. A round: every unassigned row bids on the first
column of its largest ``benefit - price`` (a NaN counts as the largest)
the gap to its second-largest value over the other columns (itself where
that is not finite) plus eps; a column whose largest bid is finite goes to
the lowest row among its largest bids, its price rising by the bid; the
rounds end when every row is assigned or at the budget. Nothing is
multiplied, so the kernel's owners equal the plain version's bit for bit.

The same rounds run the square eps-scaled auction of the in-loop OSPA
(``ops/ospa.py::ospa_torch``), which replaces the ``lax.while_loop`` inside
a ``lax.scan`` over eps phases of ``phdslam_tpu/ops/ospa.py::
_auction_assign``: ``auction_square_cuda`` runs every phase and the
clean-up in one launch, one CTA per problem; ``auction_square_plain`` is
the same in PyTorch ops; ``auction_square`` picks one by the device. They
take ``cost [B, n, n]`` (float32, in [0, 1]; the benefit is ``-cost``),
the eps schedule ``eps [n_phases]`` and a per-phase budget, and return
``owner [B, n]`` int32 (every column owned) and ``iters [B, n_phases]``
int32, the rounds of each phase. Prices carry from one phase to the next;
ownership restarts each phase; after the last one the rows left
unassigned take the columns left unowned in index order.
"""

from __future__ import annotations

import torch

from phdslam_tpu_torch.kernels import _build

#: kernel launches since the count was last set to 0 (FastSLAM's rows
#: auction; the square OSPA auction counts in ``launches_square``)
launches = 0
launches_square = 0


def _check(benefit, eps, budget):
    P, M, C = benefit.shape
    if M > 0 and C < 1:
        raise ValueError("auction: rows need at least one column")
    if not 0 <= budget < 2 ** 31:
        raise ValueError(f"auction: budget {budget} out of range")
    return P, M, C


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


def auction_rows_plain(benefit, eps, budget: int):
    """The kernel's rounds in PyTorch ops, all particles at once; a
    particle stops changing once every row is assigned or its budget is
    spent."""
    P, M, C = _check(benefit, eps, budget)
    owner, iters, _, _, _ = _rounds(benefit, eps, budget,
                                    benefit.new_zeros((P, C)))
    return owner, iters


def auction_rows_cuda(benefit, eps, budget: int):
    """Launch ``csrc/auction.cu`` on PyTorch's current stream. The benefit
    is staged in a CTA's shared memory where it fits, read from device
    memory otherwise; a state too large for shared memory (C in the tens
    of thousands) lives in device memory this wrapper allocates."""
    global launches
    P, M, C = _check(benefit, eps, budget)
    dev = benefit.device
    _build.check_tensor(benefit, (P, M, C), dev, "benefit")
    _build.check_tensor(eps, (P,), dev, "eps")
    lib, _ = _build.library()
    owner = torch.empty((P, C), dtype=torch.int32, device=dev)
    iters = torch.empty((P,), dtype=torch.int32, device=dev)
    scratch = _build.scratch(lib.phd_auction_wide_floats(P, M, C), dev)
    err = lib.phd_auction_launch(
        benefit.data_ptr(), eps.data_ptr(), owner.data_ptr(),
        iters.data_ptr(), P, M, C, int(budget), _build.ptr(scratch),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "auction kernel")
    launches += 1
    return owner, iters


def auction_rows(benefit, eps, budget: int):
    """(owner [P, C], iters [P]) of the clamped benefit [P, M, C]: the
    kernel on a CUDA tensor, its plain version on a CPU tensor."""
    run = _build.kernel_for(benefit.device, auction_rows_cuda,
                            auction_rows_plain, "auction")
    return run(benefit.contiguous(), eps.contiguous(), budget)


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
    stream: one CTA per problem, the cost staged in shared memory up to n =
    238 and read from device memory above."""
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

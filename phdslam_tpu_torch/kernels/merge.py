"""Kernel 2: greedy moment-matching merge of the candidate pool.

Replaces ``phdslam_tpu/kernels/merge_pallas.py::greedy_merge_pallas``.
``merge_cuda`` launches ``csrc/merge.cu``; ``merge_plain`` is the same
pick loop in plain PyTorch. ``ops/gm.py::greedy_merge_channels`` runs the
first on CUDA tensors and the second on CPU tensors. Both take six
``[P, K]`` candidate channels and return six ``[P, max_out]`` channels;
empty slots hold w = 0, mean 0 and the identity covariance.

The kernel takes the pick chain in batches of up to 32 with a reach gate
before each exact test (``csrc/merge.cu``'s header), wherever its tables
fit in shared memory beside the pool (K <= 7609 on an H100); wider pools
run the batched pick_loop of merge3 and merge4. ``reach``,
``gate_scale`` and ``gated_owners`` are that gate, the batches, their
resolution, the cap and the passes in plain PyTorch, with the kernel's
constants; ``greedy_owners`` is ``merge_plain``'s chain as picks and
owners, which ``gated_owners`` has to give.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from phdslam_tpu_torch.kernels import _build

#: kernel launches since the count was last set to 0
launches = 0

# csrc/merge.cu's gate: its margin, the condition numbers of a bounded
# covariance (metric 0, 1), metric 1's slack and largest min_sep, metric
# 0's min_sep range, the range of a bounded mean and reach; the batch size,
# the grid's columns and rows and the pads of a box; and the ints a
# particle's stats take (STATS names them)
DELTA = 1.0 / 16.0
KAPPA = (16384.0, 128.0)
HELLINGER_SLACK = 1.0 / 32.0
HELLINGER_MAX_SEP = 1.0 - 1.0 / 1024.0
SEP_MAX = 2.0 ** 30
BIG = 2.0 ** 40
BATCH = 32
GRID = 16
REACH_PAD = 1.0 / 1024.0
COORD_PAD = 1.0 / 65536.0
STATS = ("batches", "gate_tests", "exact_tests", "unbounded", "live",
         "slots")


def _near(metric, dx, dy, r00, r01, r11, c00, c01, c11, min_separation):
    """The kernel's neighbour test of each candidate against the pick."""
    if metric == 1:
        s00, s01, s11 = r00 + c00, r01 + c01, r11 + c11
        det_sum = s00 * s11 - s01 * s01
        safe = torch.clamp(det_sum, min=1.17549435e-38)
        eps_q = -0.25 * (dx * dx * s11 - 2.0 * dx * dy * s01
                         + dy * dy * s00) / safe
        det_prod = ((r00 * c00 + r01 * c01) * (r01 * c01 + r11 * c11)
                    - (r00 * c01 + r01 * c11) * (r01 * c00 + r11 * c01))
        dist = 1.0 - torch.sqrt(torch.clamp(
            torch.sqrt(torch.clamp(det_prod, min=0.0)) / (det_sum / 4.0),
            min=0.0)) * torch.exp(eps_q)
        return dist < min_separation
    a00 = 0.5 * (r00 + c00)
    a01 = 0.5 * (r01 + c01)
    a11 = 0.5 * (r11 + c11)
    det = a00 * a11 - a01 * a01
    # division-free form of quad / det < min_separation (det > 0)
    quad = dx * dx * a11 - 2.0 * (dx * dy) * a01 + dy * dy * a00
    return quad < min_separation * det


def _chain(w, mx, my, c00, c01, c11, min_separation, max_out, metric):
    """The greedy chain over all particles at once: per slot i, yields (i,
    pick [P, 1], whether it is live [P, 1], the candidates it takes
    [P, K] (the pick among them), dx, dy, the pick's mean [P, 1] x 2)."""
    K = w.shape[1]
    w_rem = w.clone()
    col = torch.arange(K, device=w.device)
    for i in range(max_out):
        pick = torch.argmax(w_rem, dim=1, keepdim=True)       # first max
        mval = torch.gather(w_rem, 1, pick)
        if not bool((mval > 0.0).any()):
            break
        take = lambda a: torch.gather(a, 1, pick)
        rmx, rmy = take(mx), take(my)
        r00, r01, r11 = take(c00), take(c01), take(c11)
        dx = rmx - mx
        dy = rmy - my
        near = _near(metric, dx, dy, r00, r01, r11, c00, c01, c11,
                     min_separation)
        sel = (near & (w_rem > 0.0)) | (col[None, :] == pick)
        sel = sel & (mval > 0.0)
        yield i, pick, mval > 0.0, sel, w_rem, dx, dy, rmx, rmy
        w_rem = torch.where(sel, 0.0, w_rem)


def merge_plain(w, mx, my, c00, c01, c11, min_separation: float,
                max_out: int, metric: int = 0):
    """The kernel's pick loop in PyTorch ops over all particles at once,
    with the kernel's one-pass moments centred on the pick."""
    P, K = w.shape
    z = lambda: torch.zeros((P, max_out), dtype=w.dtype, device=w.device)
    o = lambda: torch.ones((P, max_out), dtype=w.dtype, device=w.device)
    out = [z(), z(), z(), o(), z(), o()]
    for i, pick, _, sel, w_rem, dx, dy, rmx, rmy in _chain(
            w, mx, my, c00, c01, c11, min_separation, max_out, metric):
        sw = torch.where(sel, w_rem, 0.0)
        wsum = sw.sum(1)
        live = wsum > 0.0
        inv = torch.where(live, 1.0 / torch.clamp(wsum, min=1e-38), 0.0)
        mcx = (sw * dx).sum(1) * inv
        mcy = (sw * dy).sum(1) * inv
        n00 = (sw * (c00 + dx * dx)).sum(1) * inv - mcx * mcx
        n01 = (sw * (c01 + dx * dy)).sum(1) * inv - mcx * mcy
        n11 = (sw * (c11 + dy * dy)).sum(1) * inv - mcy * mcy
        vals = (wsum, torch.where(live, rmx[:, 0] - mcx, 0.0),
                torch.where(live, rmy[:, 0] - mcy, 0.0),
                torch.where(live, n00, 1.0), n01,
                torch.where(live, n11, 1.0))
        for dst, v in zip(out, vals):
            dst[:, i] = v
    return tuple(out)


def greedy_owners(w, mx, my, c00, c01, c11, min_separation: float,
                  max_out: int, metric: int = 0):
    """``merge_plain``'s chain as (picks [P, max_out]: each slot's pick,
    -1 where empty; owner [P, K]: the slot each candidate went to, its
    pick included, -1 where none), int64."""
    P, K = w.shape
    picks = torch.full((P, max_out), -1, dtype=torch.int64)
    owner = torch.full((P, K), -1, dtype=torch.int64)
    for i, pick, live, sel, *_ in _chain(w, mx, my, c00, c01, c11,
                                         min_separation, max_out, metric):
        picks[:, i] = torch.where(live[:, 0], pick[:, 0], -1).cpu()
        owner[sel.cpu()] = i
    return picks, owner


def _f32(x) -> float:
    return float(np.float32(x))


def gate_scale(min_separation: float, metric: int) -> float:
    """The kernel's gate_scale: a pair of bounded candidates can be near
    only where |d|^2 < scale (rho_q + rho_p); NaN where no candidate is
    bounded at this min_separation. In float32, as the kernel has it."""
    s = np.float32(min_separation)
    f = np.float32
    if metric == 1:
        if not s <= f(HELLINGER_MAX_SEP):
            return math.nan
        return _f32(f(4.0) * (f(HELLINGER_SLACK) - np.log1p(-s))
                    * (f(1.0) + f(DELTA)))
    if not (abs(s) <= f(SEP_MAX) and not (0.0 < s < f(1.0 / SEP_MAX))):
        return math.nan
    return _f32(f(0.5) * s * (f(1.0) + f(DELTA)))


def reach(mx, my, c00, c01, c11, metric: int):
    """The kernel's reach of each candidate (float32 tensors alike in
    shape): the largest eigenvalue of its covariance, or -1 where the
    candidate is unbounded (its mean or covariance not finite or out of
    [2^-40, 2^40], or its condition number at KAPPA[metric] or more)."""
    half = 0.5 * (c00 + c11)
    diff = 0.5 * (c00 - c11)
    lmax = half + torch.sqrt(diff * diff + c01 * c01)
    det = c00 * c11 - c01 * c01
    bounded = ((mx.abs() <= BIG) & (my.abs() <= BIG) & (c00 > 0.0)
               & (c11 > 0.0) & (lmax >= 1.0 / BIG) & (lmax <= BIG)
               & (det * KAPPA[metric] > lmax * lmax))
    return torch.where(bounded, lmax, torch.full_like(lmax, -1.0))


def inside(x, y, r, px, py, pr, scale: float):
    """The kernel's gate (tensors broadcast): whether the exact test of a
    pick (x, y, reach r) and a candidate (px, py, pr) can hold; an
    unbounded one (reach -1) passes every gate."""
    dx, dy = x - px, y - py
    return (r < 0.0) | (pr < 0.0) | (dx * dx + dy * dy < scale * (r + pr))


def cell_bounds(mx, my, rho, scale: float):
    """The kernel's grid over one particle's candidates (float32 [n]
    tensors; rho from ``reach``): per candidate its box's column and row
    bounds (x from, x to, y from, y to) as an [n, 4] int64 tensor; an
    unbounded candidate spans every cell, and where no grid is drawn (no
    bounded candidate, or scale <= 0) a bounded one spans none (from 1 to
    0). A pair inside the gate lies in boxes that meet."""
    n = len(rho)
    out = torch.tensor([1, 0, 1, 0]).repeat(n, 1)
    out[rho < 0] = torch.tensor([0, GRID - 1, 0, GRID - 1])
    bounded = rho > 0
    if not (scale > 0.0) or not bool(bounded.any()):
        return out
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    x0, x1 = mx[bounded].min(), mx[bounded].max()
    y0, y1 = my[bounded].min(), my[bounded].max()
    inv_x = GRID / (x1 - x0) if x1 > x0 else f32(0.0)
    inv_y = GRID / (y1 - y0) if y1 > y0 else f32(0.0)
    span = x0.abs() + x1.abs() + y0.abs() + y1.abs()
    root = torch.sqrt(f32(scale))
    r = torch.where(bounded, rho, torch.ones_like(rho))
    hw = (root * torch.sqrt(r) * f32(1.0 + REACH_PAD)
          + f32(COORD_PAD) * (mx.abs() + my.abs() + span))

    def index(v, lo, inv):
        return torch.clamp((v - lo) * inv, min=0.0,
                           max=float(GRID - 1)).to(torch.int64)
    box = torch.stack([index(mx - hw, x0, inv_x), index(mx + hw, x0, inv_x),
                       index(my - hw, y0, inv_y), index(my + hw, y0, inv_y)],
                      1)
    out[bounded] = box[bounded]
    return out


def gated_owners(w, mx, my, c00, c01, c11, min_separation: float,
                 max_out: int, metric: int = 0):
    """The kernel's gated chain in plain PyTorch, particle by particle (CPU
    tensors): batches of the next BATCH unmerged positions in pick order,
    resolved inside (a position is a pick where no earlier pick of the
    batch is near it, else the earliest near one takes it), the first
    max_out - n picks kept, then a pass of every later unmerged position
    against the kept picks (gate, then the exact test; the first near one
    takes it). Returns ``greedy_owners``' (picks, owner) and stats
    [P, len(STATS)] (int64): the kernel's counts but "gate_tests" (-1: the
    kernel gates only the pairs its grid cannot part)."""
    P, K = w.shape
    picks = torch.full((P, max_out), -1, dtype=torch.int64)
    owner = torch.full((P, K), -1, dtype=torch.int64)
    stats = torch.zeros((P, len(STATS)), dtype=torch.int64)
    scale = gate_scale(min_separation, metric)
    for r in range(P):
        wr = w[r]
        live = torch.nonzero(wr > 0.0)[:, 0]
        # (w descending, index ascending): the kernel's presort
        order = live[torch.from_numpy(np.lexsort((
            live.numpy(), -wr[live].double().numpy())))]
        L = len(order)
        x, y, a00, a01, a11 = (a[r][order] for a in (mx, my, c00, c01, c11))
        rho = (reach(x, y, a00, a01, a11, metric) if not math.isnan(scale)
               else torch.full((L,), -1.0))

        def near(lo, hi):               # exact, lo as the pick
            return _near(metric, x[lo] - x[hi], y[lo] - y[hi], a00[lo],
                         a01[lo], a11[lo], a00[hi], a01[hi], a11[hi],
                         min_separation)

        slot = np.full(L, -1, dtype=np.int64)   # per position
        merged = np.zeros(L, dtype=bool)
        st = dict(batches=0, gate_tests=-1, exact_tests=0)
        n, start = 0, 0
        while n < max_out:
            rest = np.flatnonzero(~merged[start:]) + start
            q = rest[:BATCH]
            if len(q) == 0:
                break
            st["batches"] += 1
            g = len(q)
            qt = torch.from_numpy(q)
            jj, kk = np.triu_indices(g, 1)      # j < k
            gate = inside(x[qt[jj]], y[qt[jj]], rho[qt[jj]], x[qt[kk]],
                          y[qt[kk]], rho[qt[kk]], scale).numpy()
            st["exact_tests"] += int(gate.sum())
            nm = np.zeros((g, g), dtype=bool)   # nm[j, k]: q_j near q_k
            jg, kg = jj[gate], kk[gate]
            nm[jg, kg] = near(qt[jg], qt[kg]).numpy()
            is_pick = np.zeros(g, dtype=bool)
            taker = np.full(g, -1)
            for k in range(g):
                by = np.flatnonzero(nm[:k, k] & is_pick[:k])
                if len(by):
                    taker[k] = by[0]
                else:
                    is_pick[k] = True
            kept = np.flatnonzero(is_pick)[:max_out - n]
            kslot = {int(k): n + i for i, k in enumerate(kept)}
            for k in range(g):
                if k in kslot:
                    slot[q[k]] = kslot[k]
                elif taker[k] in kslot:
                    slot[q[k]] = kslot[taker[k]]
            merged[q] = True
            # the pass: later unmerged positions against the kept picks
            later = np.flatnonzero(~merged[q[-1] + 1:]) + q[-1] + 1
            if len(later) and len(kept):
                kq = torch.from_numpy(q[kept])
                lt = torch.from_numpy(later)
                gate = inside(x[kq][:, None], y[kq][:, None],
                              rho[kq][:, None], x[lt][None, :],
                              y[lt][None, :], rho[lt][None, :], scale)
                took = np.full(len(later), -1)
                for i in range(len(kept)):      # kept picks in order
                    open_ = (took < 0) & gate[i].numpy()
                    idx = np.flatnonzero(open_)
                    st["exact_tests"] += len(idx)
                    if len(idx):
                        hit = near(kq[i].expand(len(idx)),
                                   lt[idx]).numpy()
                        took[idx[hit]] = i
                hit = took >= 0
                slot[later[hit]] = n + took[hit]
                merged[later[hit]] = True
            n += len(kept)
            start = q[-1] + 1
        for k, v in st.items():
            stats[r, STATS.index(k)] = v
        stats[r, STATS.index("unbounded")] = int((rho < 0).sum())
        stats[r, STATS.index("live")] = L
        stats[r, STATS.index("slots")] = n
        owner[r, order] = torch.from_numpy(slot)
        picks[r, :n] = order[torch.from_numpy(_pick_positions(slot, n))]
    return picks, owner, stats


def _pick_positions(slot, n):
    """Each filled slot's pick: its first position (the pick precedes
    what it takes)."""
    first = np.full(n, -1, dtype=np.int64)
    for p in range(len(slot) - 1, -1, -1):
        if slot[p] >= 0:
            first[slot[p]] = p
    return first


def merge_cuda(w, mx, my, c00, c01, c11, min_separation: float,
               max_out: int, metric: int = 0, stats=None):
    """Launch ``csrc/merge.cu`` on PyTorch's current stream. A pool lives
    in one CTA's shared memory up to K = 7744 (the gated chain up to 7609,
    pick_loop above); a wider one in device memory that this wrapper
    allocates, where pick_loop runs: the same bits on every path. stats:
    None, or a contiguous int32 [P, len(STATS)] tensor on the pool's device
    that takes each particle's chain counts (``STATS``; the first four read
    -1 where pick_loop ran, K > 7609)."""
    global launches
    chans = (w, mx, my, c00, c01, c11)
    P, K = w.shape
    dev = w.device
    for c in chans:
        if c.device != dev or c.dtype != torch.float32 \
                or tuple(c.shape) != (P, K) or not c.is_contiguous():
            raise ValueError(
                f"merge: expected contiguous float32 ({P}, {K}) on {dev}, "
                f"got {c.dtype} {tuple(c.shape)} on {c.device}")
    if metric not in (0, 1):
        raise ValueError(f"merge kernel has metrics 0 and 1, not {metric}")
    if stats is not None and (
            stats.device != dev or stats.dtype != torch.int32
            or tuple(stats.shape) != (P, len(STATS))
            or not stats.is_contiguous()):
        raise ValueError(f"merge: stats must be contiguous int32 "
                         f"({P}, {len(STATS)}) on {dev}")
    lib, _ = _build.library()
    outs = [torch.empty((P, max_out), dtype=torch.float32, device=dev)
            for _ in range(6)]
    scratch = _build.scratch(lib.phd_merge_wide_floats(P, K), dev)
    err = lib.phd_merge_launch(
        *(c.data_ptr() for c in chans), *(o.data_ptr() for o in outs),
        P, K, max_out, float(min_separation), int(metric),
        _build.ptr(scratch), _build.ptr(stats),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "merge kernel")
    launches += 1
    return tuple(outs)

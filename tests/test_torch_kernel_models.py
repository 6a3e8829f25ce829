"""What the select and merge3 kernels' designs rest on, shown on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``); these
tests hold the facts their designs use to the plain versions, and the tie
rule also to the JAX package's XLA select route:

- the select loop's early exit: after the last positive pick of a row,
  every pick of ``select_plain`` and ``select4_plain`` is (w 0, slot 0), in
  every output mode;
- the tie rule (v desc, slot asc) is on the normalised, rounded v: two
  distinct e that round to one v are picked lower slot first, by
  ``select_plain`` and by ``jax.lax.top_k`` (``filter/update.py:367``);
- a numpy model of the select loop's rounds (each lane's best (v, f) of its
  slots f = l + 32 i, the prefilter at the k1-th largest lane head, a round
  taking the largest value's bits, then the least slot holding it) gives
  ``top_k1``'s picks;
- the select loop's bearing wrap: Markstein's quotient (two FMAs after the
  product with 1/(2 pi)) is the IEEE float32 quotient, and its rint taken
  as (d + 1.5 2^23) - 1.5 2^23 is rint's;
- a model of the presorted merge's batched pick loop (batches of G picks,
  cut where a batch pick is near an earlier one) gives every candidate the
  slot ``merge3_plain``'s sequential loop gives it.
- a model of the esf kernel's schedule (the full set's lane run once, each
  deleted lane started from its coefficients before the deleted step, each
  lane updating only k <= n + 1, and a deleted lane k <= M - 1) gives
  ``esf_all_plain``'s outputs bit for bit, with the update count the kernel
  makes.

Exact comparisons throughout: each is a statement about float32 values.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu_torch import load_config
from phdslam_tpu_torch.filter.state import (Gaussian2DMixture,
                                            Gaussian4DMixture)
from phdslam_tpu_torch.filter.update import gather_selected, kalman_preupdate
from phdslam_tpu_torch.filter.update4 import (gather_selected4,
                                              kalman_preupdate4)
from phdslam_tpu_torch.kernels import esf as E
from phdslam_tpu_torch.kernels import merge3 as M3
from phdslam_tpu_torch.kernels import select as S
from phdslam_tpu_torch.kernels import select4 as S4

torch.set_num_threads(1)

K1 = 8


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# ------------------------------------------------------- the early exit --

def _sparse_maps(rng, P, F, live):
    """Few live slots (the rest w = 0, so lpw = -1e30 and e = 0 exactly),
    features within 10 m."""
    w = (rng.uniform(size=(P, F)) < live) * rng.uniform(0.05, 1.0, (P, F))
    pose = _t(np.concatenate([rng.normal(0, 0.3, (P, 3)),
                              np.zeros((P, 3))], 1))
    return w, pose


def _select_problem(rng, P=12, F=40, M=10, live=0.15):
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=P, maxFeatures=F, maxMeasurements=M)
    w, pose = _sparse_maps(rng, P, F, live)
    c00, c11 = rng.uniform(0.1, 2.0, (2, P, F))
    gm = Gaussian2DMixture(
        w=_t(w), mx=_t(rng.uniform(-2, 12, (P, F))),
        my=_t(rng.uniform(-10, 10, (P, F))), c00=_t(c00),
        c01=_t(0.3 * np.sqrt(c00 * c11) * rng.uniform(-1, 1, (P, F))),
        c11=_t(c11))
    z = _t(np.stack([rng.uniform(0.5, 10, M), rng.uniform(-1.6, 1.6, M)],
                    1))
    return cfg, kalman_preupdate(pose, gm, cfg), gm, z


def _after_last_positive(w_sel):
    """[..., k1] mask of the picks after a row's last positive one, and the
    count of rows that have such picks."""
    pos = w_sel > 0
    n_pos = pos.sum(-1, keepdim=True)
    after = torch.arange(w_sel.shape[-1]) >= n_pos
    # picks descend, so the positive ones come first
    assert torch.equal(pos, ~after)
    return after, int(after.any(-1).sum())


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("by_index", [False, True])
def test_select_plain_picks_zero_slot_after_the_last_positive(raw, by_index):
    cfg, pre, gm, z = _select_problem(np.random.default_rng(3))
    chans = S.select_channels(pre, gm)[:S.N_LOOP if by_index else 16]
    M = z.shape[0]
    nv = torch.tensor([M - 2], dtype=torch.int32)
    kw = dict(k1=K1, clutter_birth=float(cfg.clutterDensity
                                         + cfg.birthWeight),
              min_weight=float(cfg.minFeatureWeight), gate_threshold=9.0,
              raw=raw, with_compat=True, by_index=by_index)
    out = S.select_plain(chans, z, nv, **kw)
    w_sel = out[1]
    after, n_rows = _after_last_positive(w_sel)
    assert n_rows >= w_sel.shape[0] * (M - 2) // 2   # most rows exit early
    # the rounds themselves: slot 0 after the last positive pick
    e, _ = S.likelihoods(chans[:S.N_LOOP], z)
    if not raw:
        v = e * (1.0 / (e.sum(-1) + kw["clutter_birth"]))[..., None]
        e = torch.where(v >= kw["min_weight"], v, 0.0)
    v_sel, f_sel = S.top_k1(e, K1)
    assert torch.equal(v_sel[:, :M - 2], w_sel[:, :M - 2])
    assert not f_sel[after[:, :M] & (torch.arange(M) < M - 2)[None, :, None]
                     ].any()
    if by_index:
        assert not out[2][after].any()
        return
    zero = gather_selected(pre, gm, z, torch.zeros_like(f_sel),
                           with_lpw=True)
    for got, want in zip(out[2:7], zero[:5]):
        torch.testing.assert_close(got[:, :M - 2][after[:, :M - 2]],
                                   want[:, :M - 2][after[:, :M - 2]],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("by_index", [False, True])
def test_select4_plain_picks_zero_slot_after_the_last_positive(by_index):
    rng = np.random.default_rng(4)
    P, F, M = 10, 40, 9
    cfg = load_config("cfg/mixed_synth.cfg").replace(
        n_particles=P, maxFeatures=F, maxMeasurements=M)
    w, pose = _sparse_maps(rng, P, F, 0.15)
    a = rng.normal(size=(P, F, 4, 4)) * 0.5
    cov = a @ np.swapaxes(a, -1, -2) + 0.2 * np.eye(4)
    gm4 = Gaussian4DMixture(
        w=_t(w), mean_channels=_t(np.concatenate(
            [rng.uniform(-8, 8, (P, 2, F)), rng.normal(0, 0.5, (P, 2, F))],
            1)),
        cov_channels=_t(np.stack([cov[..., i, j] for i in range(4)
                                  for j in range(i, 4)], 1)))
    z = _t(np.stack([rng.uniform(0.5, 10, M), rng.uniform(-1.6, 1.6, M)],
                    1))
    pre4 = kalman_preupdate4(pose, gm4, cfg)
    loop, gain, mean, cov4 = S4.select4_channels(pre4, gm4)
    out = S4.select4_plain(loop, gain, mean, cov4, z, k1=K1,
                           by_index=by_index)
    after, n_rows = _after_last_positive(out[1])
    assert n_rows >= P * M // 2
    e, _ = S.likelihoods(loop, z)
    _, f_sel = S.top_k1(e, K1)
    assert not f_sel[after].any()
    if by_index:
        assert not out[2][after].any()
        return
    zmean, zcov = gather_selected4(pre4, gm4, z, torch.zeros_like(f_sel))
    for got, want in ((out[2], zmean), (out[3], zcov)):
        lv = after[:, None].expand_as(got)
        torch.testing.assert_close(got[lv], want[lv], rtol=0, atol=1e-6)


# ----------------------------------------------------------- the tie rule --

def _colliding_top(values_of, start, n=24, tries=2000):
    """Slide a run of n adjacent float32 inputs up from start until the two
    largest outputs of values_of (non-decreasing in the input, so largest
    last) are one float, the third largest another, and the intermediates
    of the top two differ; values_of(xs) -> (intermediates, outputs).
    Returns (inputs, outputs)."""
    x = np.float32(start)
    for _ in range(tries):
        xs = [x]
        for _ in range(n - 1):
            xs.append(np.nextafter(xs[-1], np.float32(np.inf),
                                   dtype=np.float32))
        xs = np.array(xs, np.float32)
        mid, out = values_of(xs)
        if out[-1] == out[-2] != out[-3] and mid[-1] != mid[-2]:
            return xs, out
        x = xs[1]
    raise AssertionError("no collision found")


def test_select_plain_breaks_a_rounded_tie_by_the_lower_slot():
    """Every slot at the measurement (d2 = 0, e = exp(lpw - log 2pi)), lpw
    rising one ulp a slot (near 0.95, where lpw - log 2pi is exact): the
    two top slots have distinct e but one normalised v, and the lower slot
    is picked first."""
    F, cb = 24, 0.05
    z = _t([[3.0, 0.25]])
    ones = torch.ones((1, F))

    def chans_of(lpw):
        return [ones * 3.0, ones * 0.25, _t(lpw)[None], ones, ones * 0.0,
                ones, ones * 0.0]

    def v_of(lpw):
        e, _ = S.likelihoods(chans_of(lpw), z)
        v = e * (1.0 / (e.sum(-1) + cb))[..., None]
        return e[0, 0].numpy(), v[0, 0].numpy()

    lpw, v = _colliding_top(v_of, 0.95)
    e, _ = S.likelihoods(chans_of(lpw), z)
    assert e[0, 0, -1] != e[0, 0, -2]
    _, w_sel, idx, _ = S.select_plain(
        chans_of(lpw), z, torch.tensor([1], dtype=torch.int32), k1=4,
        clutter_birth=cb, min_weight=1e-5, gate_threshold=9.0,
        by_index=True)
    assert idx[0, 0, :2].tolist() == [F - 2, F - 1]
    assert w_sel[0, 0, 0] == w_sel[0, 0, 1] == v[-1]


def test_xla_top_k_breaks_a_rounded_tie_by_the_lower_slot():
    """The XLA route normalises as exp(lw - log norm) (update.py:311) and
    picks with lax.top_k (:367): two distinct lw whose normalised values
    round to one float are picked lower slot first."""
    log_norm = jnp.float32(0.0)

    def w_of(lw):
        return lw, np.asarray(jnp.exp(jnp.asarray(lw) - log_norm))

    lw, w = _colliding_top(w_of, -0.6)
    w_det = jnp.where(jnp.asarray(w) >= 1e-5, jnp.asarray(w), 0.0)
    vals, idx = jax.lax.top_k(w_det[None, None], 4)
    n = len(lw)
    assert np.asarray(idx)[0, 0, :2].tolist() == [n - 2, n - 1]
    assert float(vals[0, 0, 0]) == float(vals[0, 0, 1])


# ------------------------------------------------ the lane-head rounds --

def lane_head_rounds(v, k1):
    """The select loop's rounds on one row v [F] (float32, NaN stored as
    0): lane l holds slots l + 32 i and its head, the best of them. The
    prefilter takes k1 rounds over the heads alone (the lowest lane holding
    the largest drops it) for the k1-th largest head, zeroes the values
    below it (keeps every positive one when fewer than k1 heads are
    positive) and counts what each lane keeps. A round then takes the
    largest bits of the heads, the least slot holding them; the winner's
    lane rescans unless it has nothing left. A zero best ends the row: the
    rest are (0, 0)."""
    v = np.where(v > 0, v, np.float32(0)).astype(np.float32)
    F = len(v)
    bits = v.view(np.uint32).copy()
    lanes = [list(range(l, F, 32)) for l in range(32)]

    def head(l):
        hb, hf = np.uint32(0), None
        for f in lanes[l]:
            if bits[f] > hb:
                hb, hf = bits[f], f
        return hb, hf

    heads = [head(l) for l in range(32)]
    t = [h[0] for h in heads]
    thr, found = np.uint32(1), 0
    for _ in range(k1):
        vb = max(t)
        if vb == 0:
            break
        thr, found = vb, found + 1
        t[t.index(vb)] = 0
    if found < k1:
        thr = np.uint32(1)
    bits[bits < thr] = 0
    left = [int((bits[lanes[l]] > 0).sum()) for l in range(32)]
    heads = [head(l) for l in range(32)]
    picks = [(np.float32(0), 0)] * k1
    for j in range(k1):
        vb = max(h[0] for h in heads)
        if vb == 0:
            break
        f = min(h[1] for h in heads if h[0] == vb)
        picks[j] = (np.uint32(vb).view(np.float32), f)
        left[f % 32] -= 1
        bits[f] = 0
        heads[f % 32] = head(f % 32) if left[f % 32] else (np.uint32(0),
                                                            None)
    return picks


@pytest.mark.parametrize("F,k1", [(33, 8), (512, 8), (513, 32), (1000, 8)])
def test_lane_head_rounds_give_top_k1(F, k1):
    """Rows with exact ties (duplicated values), zeros, NaN and fewer
    positive values than k1, with most slots dead: the model runs on the
    live slots alone (the staging's compaction, in slot order) and maps
    each position back to its slot."""
    rng = np.random.default_rng(F)
    rows = []
    for kind in range(6):
        v = rng.uniform(0, 1, F).astype(np.float32)
        if kind == 1:                           # ties throughout
            v = np.round(v * 4).astype(np.float32) / 4
        elif kind == 2:                         # a few positive values
            v = np.where(rng.uniform(size=F) < 4 / F, v, 0).astype(
                np.float32)
        elif kind == 3:                         # all zero
            v[:] = 0
        elif kind == 4:                         # duplicated slots
            v[rng.integers(0, F, F // 2)] = v.max()
        elif kind == 5:                         # NaN at some slots
            v[rng.integers(0, F, 5)] = np.nan
        rows.append(v)
    rows = np.stack(rows)
    dead = rng.uniform(size=rows.shape) < 0.6   # left out of the staging
    dead[3] = True                              # a row with no live slot
    rows[dead] = 0
    clean = torch.as_tensor(np.where(rows > 0, rows, 0).astype(np.float32))
    w_ref, f_ref = S.top_k1(clean, k1)
    for r, v in enumerate(rows):
        live = np.flatnonzero(~dead[r])
        picks = lane_head_rounds(v[live], k1)
        # a position maps to its slot; the exit's picks are slot 0
        got = [(float(w), int(live[c]) if w > 0 else 0) for w, c in picks]
        assert [p[1] for p in got] == f_ref[r].tolist()
        assert [p[0] for p in got] == w_ref[r].tolist()


# ------------------------------------------------------ the bearing wrap --

def _rn32(x):
    """The float32 nearest the exact rational x, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf), dtype=np.float32), f,
             np.nextafter(f, np.float32(np.inf), dtype=np.float32)]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.float32(c).view(np.uint32)) & 1))


def _fma32(a, b, c):
    """RN(a b + c) in float32, as one FMA rounds it."""
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def test_wrap_round_quotient_is_the_correctly_rounded_one():
    """The select loop's bearing wrap takes Markstein's quotient, q = RN(x
    y), y = RN(1 / 2pi), then RN(q + RN(x - 2pi q) y), each step one FMA
    rounding (emulated exactly), and rint as (d + 1.5 2^23) - 1.5 2^23:
    the same k as rint(x / 2pi) with the IEEE float32 quotient, on the
    bearings' range, at and around every half-integer quotient up to
    |q| = 40, and on wide random values."""
    rng = np.random.default_rng(7)
    two_pi = np.float32(6.283185307179586)
    y = np.float32(0.15915494309189535)
    assert y == np.float32(1) / two_pi
    magic = np.float32(12582912.0)
    halves = (np.arange(-40, 40) + 0.5) * 2 * np.pi
    near = (halves[:, None] * (1 + np.arange(-24, 25)[None, :] * 2.0 ** -24)
            ).astype(np.float32).ravel()
    x = np.concatenate([rng.uniform(-4 * np.pi, 4 * np.pi, 1500), near,
                        rng.uniform(-2e5, 2e5, 500),
                        np.float32(10.0) ** rng.uniform(-30, 6, 500)
                        * rng.choice([-1, 1], 500)]).astype(np.float32)
    for xi in x:
        q = _rn32(Fraction(float(xi)) * Fraction(float(y)))
        d = _fma32(_fma32(-q, two_pi, xi), y, q)
        assert d == np.float32(xi) / two_pi, xi
        k = (d + magic) - magic if abs(d) < 2 ** 22 else np.rint(d)
        assert k == np.rint(np.float32(xi) / two_pi)
    # and the wrap the plain version computes is that rint's
    k = np.rint(x / two_pi)
    np.testing.assert_array_equal(S._wrap_round(torch.as_tensor(x)).numpy(),
                                  (x - two_pi * k).astype(np.float32))


# ---------------------------------------- the merge3 batched pick loop --

def _disparity_pool(rng, P, K):
    """Disparity-space candidates packed tight (u, v in a 40-pixel box), so
    that batch picks are often near earlier ones."""
    w = (rng.uniform(size=(P, K)) < 0.7) * rng.uniform(0.01, 2.0, (P, K))
    w[:, 5] = w[:, 9] = w.max()                     # an exact weight tie
    mean = np.stack([rng.uniform(300, 340, (P, K)),
                     rng.uniform(200, 240, (P, K)),
                     rng.uniform(50, 120, (P, K))])
    a = rng.normal(size=(P, K, 3, 3)) * np.array([3.0, 3.0, 12.0])[:, None]
    cov = a @ np.swapaxes(a, -1, -2) + np.diag([4.0, 4.0, 25.0])
    return [_t(c) for c in [w, *mean] + [cov[..., i, j]
                                         for i, j in M3.PAIRS]]


def _near(pool, sep, i):
    """[K] candidate j near the pick i, merge3_plain's test."""
    means, covs = pool[1:4], pool[4:]
    return M3.mahalanobis3([0.5 * (c[i] + c) for c in covs],
                           [m[i] - m for m in means]) < sep


def sequential_slots(pool, sep, cap):
    """merge3_plain's loop on one particle: the slot of every candidate (-1
    where none)."""
    w_rem = pool[0].clone()
    slot = torch.full(w_rem.shape, -1)
    for s in range(cap):
        pick = int(torch.argmax(w_rem))
        if not w_rem[pick] > 0:
            break
        sel = (_near(pool, sep, pick) & (w_rem > 0)) \
            | (torch.arange(len(w_rem)) == pick)
        slot[sel] = s
        w_rem = torch.where(sel, 0.0, w_rem)
    return slot


def batched_slots(pool, sep, cap, G):
    """merge_common.cuh::pick_loop on one particle: sorted positions,
    batches of G picks tested in one pass, first near pick wins, a batch
    cut at its first pick near an earlier one. Returns (slot of every
    candidate, batches cut)."""
    w = pool[0]
    live = [j for j in range(len(w)) if w[j] > 0]
    order = sorted(live, key=lambda j: (-float(w[j]), j))
    L = len(order)
    near = {}

    def is_near(pi, pj):            # candidate order[pj] near pick order[pi]
        if pi not in near:
            near[pi] = _near(pool, sep, order[pi])
        return bool(near[pi][order[pj]])

    owner = [-1] * L
    picks = []
    n = frm = cuts = 0
    while n < cap:
        q = [p for p in range(frm, L) if owner[p] < 0][:min(G, cap - n)]
        if not q:
            break
        g = len(q)
        cut, qown, taken = g, [-1] * g, {}
        for p in range(q[0] + 1, L):
            if owner[p] >= 0:
                continue
            own = next((j for j in range(g) if q[j] < p
                        and is_near(q[j], p)), -1)
            if own < 0:
                continue
            if p <= q[-1]:                    # a batch pick near an earlier
                k = q.index(p)
                qown[k] = own
                cut = min(cut, k)
            else:
                taken[p] = own
        for p, own in taken.items():
            if own < cut:
                owner[p] = n + own
        for t in range(cut, g):
            if 0 <= qown[t] < cut:
                owner[q[t]] = n + qown[t]
        cuts += cut < g
        for t in range(cut):
            owner[q[t]] = n + t
            picks.append(q[t])
        n += cut
        frm = q[cut - 1] + 1
    slot = torch.full(w.shape, -1)
    for p, o in enumerate(owner):
        slot[order[p]] = o
    return slot, cuts


@pytest.mark.parametrize("G", [1, 2, 8])
def test_batched_pick_loop_gives_merge3_plains_slots(G):
    rng = np.random.default_rng(11)
    P, K = 6, 90
    chans = _disparity_pool(rng, P, K)
    cuts = 0
    for sep, cap in ((4.0, 64), (16.0, 64), (4.0, 7)):
        plain = M3.merge3_plain(*chans, sep, cap)
        for p in range(P):
            pool = [c[p] for c in chans]
            want = sequential_slots(pool, sep, cap)
            got, c = batched_slots(pool, sep, cap, G)
            cuts += c
            assert torch.equal(got, want), (sep, cap, p)
            # the sequential model is merge3_plain's loop: same slot weights
            sw = torch.zeros(cap).index_add_(
                0, want[want >= 0], pool[0][want >= 0])
            torch.testing.assert_close(sw, plain[0][p], rtol=1e-6,
                                       atol=1e-6)
    assert (cuts > 0) == (G > 1)


# ------------------------------------------------------ the esf schedule --

def esf_schedule(log_lambda):
    """csrc/esf.cu's schedule: lanes m > j (not yet at their deleted step)
    are not computed but hold the full lane's coefficients; a lane updates
    only k <= n + 1 (n: its steps applied), a deleted lane k <= M - 1, and
    a step at the sentinel nothing. Each update is the plain version's
    operation on the same operands at the same place of a tensor of
    ``esf_all_plain``'s shape (so both run the same float32 code for it).
    Returns (esf, esfd, updates per particle [P])."""
    P, M = log_lambda.shape
    ll = torch.clamp(log_lambda, min=E.SENTINEL)
    lane = torch.arange(M + 1)
    k = torch.arange(M + 1)
    e = ll.new_full((P, M + 1, M + 1), E.SENTINEL)
    e[:, :, 0] = 0.0
    pad = ll.new_full((P, M + 1, 1), E.SENTINEL)
    n = torch.zeros((P, M + 1), dtype=torch.int64)
    k_max = torch.where(lane == M, M, M - 1)
    updates = torch.zeros(P, dtype=torch.int64)
    for j in range(M):
        val = torch.where(lane == j, E.SENTINEL, ll[:, j, None])
        shifted = torch.cat([pad, e[:, :, :-1]], dim=-1)
        new = E.logaddexp_finite(e, val[:, :, None] + shifted)
        live = val > E.SENTINEL
        top = torch.minimum(n + 1, k_max)
        upd = live[:, :, None] & (k >= 1) & (k <= top[:, :, None])
        ahead = (lane > j) & (lane < M)             # copies, not computed
        updates += (upd & ~ahead[:, None]).sum((1, 2))
        e = torch.where(upd, new, e)
        e = torch.where(ahead[:, None], e[:, M:M + 1], e)
        n = n + live
    return e[:, M], e[:, :M, :M], updates


@pytest.mark.parametrize("P,M,kind", [
    (3, 64, "live"), (4, 1, "live"), (4, 2, "live"), (5, 33, "holes"),
    (3, 65, "holes"), (6, 20, "dead rows"), (5, 17, "padded")])
def test_esf_schedule_is_esf_all_plain_bit_for_bit(P, M, kind):
    """The kernel's schedule against esf_all_plain, exactly; with every
    measurement live, 87,424 updates per particle at M = 64 against the
    131,104 logaddexps of the first design (chip_smoke.esf_logaddexps)."""
    rng = np.random.default_rng(P * 100 + M)
    ll = rng.normal(-1.0, 2.0, (P, M)).astype(np.float32)
    if kind == "holes":             # per-particle -inf: live counts differ
        ll[rng.uniform(size=(P, M)) < 0.3] = -np.inf
    elif kind == "dead rows":       # all-sentinel rows beside live ones
        ll[::2] = -np.inf
    elif kind == "padded":
        ll[:, M - 5:] = -np.inf
    ll = torch.as_tensor(ll)
    esf, esfd, updates = esf_schedule(ll)
    want_esf, want_esfd = E.esf_all_plain(ll)
    assert torch.equal(esf, want_esf) and torch.equal(esfd, want_esfd)
    nl = (ll > E.SENTINEL).sum(1)
    # the full lane: sum_{i<n} (i + 1); a live deleted lane: it holds the
    # full lane's first ones, then adds only k <= min(i + 1, M - 1)
    full = nl * (nl + 1) // 2
    assert bool((updates >= full).all())
    if kind == "live":
        want = M * (M + 1) // 2 + sum(
            (M - 1) * M // 2 - m * (m + 1) // 2 for m in range(M))
        assert bool((updates == want).all())
        if M == 64:
            assert want == 87424 and M * (M * (M - 1) // 2) + M * (M + 1) \
                // 2 == 131104

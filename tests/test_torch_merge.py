"""The merge kernel's plain version against the JAX package's XLA
``ops/gm.greedy_merge_channels`` (the route JAX takes on the CPU), at the
shapes tests/test_pallas.py holds the Pallas merge to.

Tolerance: rtol 1e-5 / atol 1e-6 on weights and means, as there; 1e-4 /
1e-5 on covariances, because the kernel's one-pass centred moments and the
XLA two-pass moments differ in rounding (tests/test_pallas.py uses the same
bound for the 4-D merge)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.ops import gm as JGM
from phdslam_tpu_torch.kernels import merge as TM
from phdslam_tpu_torch.ops import gm as TGM

torch.set_num_threads(1)

NAMES = ("w", "mx", "my", "c00", "c01", "c11")


def _pool(rng, P, K, corr=0.4, zero_rows=()):
    w = (rng.uniform(size=(P, K)) < 0.6) * rng.uniform(0.01, 2.0, (P, K))
    w[list(zero_rows)] = 0.0
    mx = rng.uniform(-20, 20, (P, K))
    my = rng.uniform(-20, 20, (P, K))
    c00 = rng.uniform(0.05, 1.5, (P, K))
    c11 = rng.uniform(0.05, 1.5, (P, K))
    c01 = corr * np.sqrt(c00 * c11) * rng.uniform(-1, 1, (P, K))
    return [a.astype(np.float32) for a in (w, mx, my, c00, c01, c11)]


def _check(got, ref, tag=""):
    for name, g, r in zip(NAMES, got, ref):
        cov = name.startswith("c")
        np.testing.assert_allclose(
            g.numpy(), np.asarray(r), rtol=1e-4 if cov else 1e-5,
            atol=1e-5 if cov else 1e-6, err_msg=f"{tag} {name}")


@pytest.mark.parametrize("P,K,cap,metric,sep", [
    (32, 160, 64, 0, 4.0),      # metric 0
    (25, 96, 48, 0, 4.0),       # odd particle count
    (16, 96, 7, 0, 4.0),        # odd cap, reached before the pool empties
    (16, 96, 33, 0, 4.0),       # odd cap
    (32, 128, 48, 1, 0.6),      # Hellinger
])
def test_plain_merge_matches_xla(rng, P, K, cap, metric, sep):
    arrs = _pool(rng, P, K, corr=0.3 if metric else 0.4, zero_rows=(1,))
    ref = JGM.greedy_merge_channels(*(jnp.asarray(a) for a in arrs), sep,
                                    cap, metric=metric, use_pallas=False)
    got = TM.merge_plain(*(torch.as_tensor(a) for a in arrs), sep, cap,
                         metric)
    for g in got:
        assert g.shape == (P, cap)
    _check(got, ref, f"P={P} cap={cap} metric={metric}")
    # the all-zero row is an empty map: w 0, mean 0, identity covariance
    np.testing.assert_array_equal(got[0][1].numpy(), 0.0)
    np.testing.assert_array_equal(got[3][1].numpy(), 1.0)
    np.testing.assert_array_equal(got[4][1].numpy(), 0.0)


def test_merge_entry_point_dispatches_to_plain_on_cpu(rng):
    """ops.gm.greedy_merge_channels on CPU tensors runs the plain version:
    the same numbers, and no kernel launch."""
    arrs = [torch.as_tensor(a) for a in _pool(rng, 8, 40)]
    before = TM.launches
    got = TGM.greedy_merge_channels(*arrs, 4.0, 16, metric=0)
    ref = TM.merge_plain(*arrs, 4.0, 16, 0)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert TM.launches == before


def test_fast_prune_renormalize_matches_jax(rng):
    w = (rng.uniform(size=(6, 50)) * (rng.uniform(size=(6, 50)) < 0.7)
         * 0.01).astype(np.float32)
    w[2] = 0.0
    got = TGM.fast_prune_renormalize(torch.as_tensor(w), 1e-3)
    ref = JGM.fast_prune_renormalize(jnp.asarray(w), 1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=0)


# ---------------------------------------------------------------------------
# csrc/merge.cu's gated chain: its gate holds every exactly near pair, and
# its batches, their resolution, the cap and the gated passes give the
# chain's picks and owners (kernels/merge.py's plain models; pools:
# merge_pools.py)

import re  # noqa: E402
from pathlib import Path  # noqa: E402

import merge_pools as MP  # noqa: E402


def _tensors(arrs):
    return [torch.as_tensor(a) for a in arrs]


def _sorted_channels(pool, r):
    """Particle r's live candidates in the kernel's pick order (w
    descending, index ascending): mx, my, c00, c01, c11."""
    w = pool[0][r].numpy()
    live = np.flatnonzero(w > 0)
    order = live[np.lexsort((live, -w[live].astype(np.float64)))]
    return [a[r][torch.as_tensor(order)] for a in pool[1:]]


def _missed(ch, sep, metric):
    """Pairs q < p (pick order) the exact float32 test calls near but the
    kernel's gate would not test, or whose boxes its grid parts; and the
    near pairs."""
    mx, my, c00, c01, c11 = ch
    near = TM._near(metric, mx[:, None] - mx[None, :],
                    my[:, None] - my[None, :], c00[:, None], c01[:, None],
                    c11[:, None], c00[None, :], c01[None, :], c11[None, :],
                    sep)
    near = torch.triu(near, 1)
    scale = TM.gate_scale(sep, metric)
    rho = TM.reach(mx, my, c00, c01, c11, metric)
    tested = TM.inside(mx[:, None], my[:, None], rho[:, None], mx[None, :],
                       my[None, :], rho[None, :], scale)
    cells = TM.cell_bounds(mx, my, rho, scale)
    meet = ((cells[:, None, 0] <= cells[None, :, 1])
            & (cells[None, :, 0] <= cells[:, None, 1])
            & (cells[:, None, 2] <= cells[None, :, 3])
            & (cells[None, :, 2] <= cells[:, None, 3]))
    either = (rho[:, None] < 0) | (rho[None, :] < 0)
    return int((near & ~(tested & (meet | either))).sum()), int(near.sum())


GATE_POOLS = [                  # (kind, P, K, metric, min_separation)
    ("random", 3, 700, 0, 5.0),
    ("course", 2, 1088, 0, 5.0),    # dense8k's pool width and min_sep
    ("course", 3, 704, 0, 5.0),     # wide65k's
    ("chain", 4, 400, 0, 5.0),
    ("outliers", 4, 500, 0, 5.0),   # unbounded candidates, ties
    ("random", 3, 500, 1, 0.6),
    ("outliers", 4, 500, 1, 0.6),
    ("course", 2, 704, 1, 0.3),
]


@pytest.mark.parametrize("kind,P,K,metric,sep", GATE_POOLS)
def test_gate_holds_every_near_pair(kind, P, K, metric, sep):
    """On every pair of every particle (pick order), the kernel's exact
    float32 test calls no pair near that its gate would not test or whose
    boxes its grid would part (an unbounded candidate meets every other)."""
    pool = _tensors(MP.POOLS[kind](P, K, 100 + K))
    n_near = 0
    for r in range(P):
        missed, near = _missed(_sorted_channels(pool, r), sep, metric)
        assert missed == 0, f"particle {r}: {missed} near pairs missed"
        n_near += near
    assert n_near > 0


@pytest.mark.parametrize("metric,sep", [
    (0, 5.0), (0, 0.5), (0, 40.0), (1, 0.6), (1, 0.1), (1, 0.95),
])
def test_gate_holds_at_the_edge_of_the_exact_test(metric, sep):
    """Float32 pairs whose means lie within 2 % of where the exact test
    turns, along the averaged covariance's major axis (where |d|^2 over
    the reaches is largest), covariances aligned or crossed, condition
    numbers up to KAPPA: every pair the exact test calls near lies inside
    the gate, which holds kDelta (and metric 1's slack) of margin against
    the test's rounding, and both sides of the turn are sampled."""
    n = 200_000
    q, cq, p, cp = (torch.as_tensor(a) for a in MP.edge_pairs(
        n, 7 + metric, metric, sep, TM.KAPPA[metric]))
    near = TM._near(metric, q[:, 0] - p[:, 0], q[:, 1] - p[:, 1], cq[:, 0],
                    cq[:, 1], cq[:, 2], cp[:, 0], cp[:, 1], cp[:, 2], sep)
    rq = TM.reach(q[:, 0], q[:, 1], cq[:, 0], cq[:, 1], cq[:, 2], metric)
    rp = TM.reach(p[:, 0], p[:, 1], cp[:, 0], cp[:, 1], cp[:, 2], metric)
    assert bool(((rq > 0) & (rp > 0)).all())      # every one bounded
    dx, dy = q[:, 0] - p[:, 0], q[:, 1] - p[:, 1]
    inside = dx * dx + dy * dy < TM.gate_scale(sep, metric) * (rq + rp)
    assert 0.2 < float(near.float().mean()) < 0.8
    assert int((near & ~inside).sum()) == 0


def test_reach_marks_the_unbounded_candidates():
    """reach: finite, positive definite covariances of condition number
    below KAPPA, means and reach in [2^-40, 2^40], are bounded, with their
    largest eigenvalue; everything else is -1."""
    big, k0 = TM.BIG, TM.KAPPA[0]
    rows = [  # (mx, my, c00, c01, c11, bounded)
        (0.0, 0.0, 2.0, 0.0, 1.0, True),
        (1e3, -1e3, 1.0, 0.5, 1.0, True),
        (0.0, 0.0, 1.0, 0.0, 1.0 / (k0 * 1.01), False),   # condition
        (0.0, 0.0, 1.0, 0.0, 1.0 / (k0 * 0.99), True),
        (0.0, 0.0, 1.0, 1.0, 1.0, False),                 # singular
        (0.0, 0.0, 1.0, 1.5, 1.0, False),                 # indefinite
        (0.0, 0.0, -1.0, 0.0, -1.0, False),
        (0.0, 0.0, 0.0, 0.0, 0.0, False),
        (0.0, 0.0, 1e-13, 0.0, 1e-13, False),             # reach < 2^-40
        (0.0, 0.0, 1e13, 0.0, 1e13, False),               # reach > 2^40
        (2.0 * big, 0.0, 1.0, 0.0, 1.0, False),           # mean
        (float("nan"), 0.0, 1.0, 0.0, 1.0, False),
        (0.0, float("inf"), 1.0, 0.0, 1.0, False),
        (0.0, 0.0, float("nan"), 0.0, 1.0, False),
        (0.0, 0.0, 1.0, float("inf"), 1.0, False),
    ]
    cols = [torch.tensor([r[i] for r in rows], dtype=torch.float32)
            for i in range(5)]
    rho = TM.reach(*cols, 0)
    want = torch.tensor([r[5] for r in rows])
    assert torch.equal(rho > 0, want)
    assert bool((rho[~want] == -1.0).all())
    np.testing.assert_allclose(rho[:2].numpy(), [2.0, 1.5], rtol=1e-6)
    # metric 1 bounds the condition number at KAPPA[1]
    c11 = torch.tensor([1.0 / (TM.KAPPA[1] * 1.01),
                        1.0 / (TM.KAPPA[1] * 0.99)])
    z = torch.zeros(2)
    assert (TM.reach(z, z, torch.ones(2), z, c11, 1) > 0).tolist() == [
        False, True]


def test_gate_scale_marks_where_no_candidate_is_bounded():
    """Metric 1 from min_sep 1 - 2^-10 on and metric 0 outside [2^-30,
    2^30] (or at a NaN) leave every candidate unbounded; min_sep <= 0 bounds
    them all with a gate nothing passes."""
    assert math.isnan(TM.gate_scale(1.0, 1))
    assert math.isnan(TM.gate_scale(0.9995, 1))
    assert TM.gate_scale(0.999, 1) > 0
    assert math.isnan(TM.gate_scale(2.0 ** 31, 0))
    assert math.isnan(TM.gate_scale(1e-10, 0))
    assert math.isnan(TM.gate_scale(float("nan"), 0))
    assert TM.gate_scale(0.0, 0) == 0.0
    assert TM.gate_scale(-1.0, 0) < 0 and TM.gate_scale(-1.0, 1) < 0
    assert TM.gate_scale(5.0, 0) == pytest.approx(2.5 * (1 + TM.DELTA))


def test_merge_cu_states_the_gate_constants():
    """The constants of kernels/merge.py's plain models are csrc/merge.cu's
    (read from the source)."""
    src = (Path(TM.__file__).resolve().parent.parent / "csrc"
           / "merge.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr (?:float|int) {name} = ([^;]+);", src)
        assert m, name
        return float(eval(m.group(1).replace("f", "")))
    assert const("kDelta") == TM.DELTA
    assert (const("kKappa0"), const("kKappa1")) == TM.KAPPA
    assert const("kHellingerSlack") == TM.HELLINGER_SLACK
    assert const("kHellingerMaxSep") == TM.HELLINGER_MAX_SEP
    assert const("kSepMax") == TM.SEP_MAX
    assert const("kBig") == TM.BIG
    assert const("kStats") == len(TM.STATS)


BATCH_POOLS = [             # (kind, P, K, cap, metric, min_separation)
    ("random", 3, 600, 200, 0, 5.0),
    ("random", 4, 300, 7, 0, 5.0),      # the cap cuts a batch short
    ("course", 2, 1088, 512, 0, 5.0),
    ("course", 3, 704, 128, 0, 5.0),
    ("chain", 8, 400, 300, 0, 5.0),     # chains through batches
    ("outliers", 6, 500, 200, 0, 5.0),  # unbounded candidates, ties
    ("outliers", 4, 300, 64, 1, 0.6),
    ("random", 3, 400, 100, 1, 1.0),    # every candidate unbounded
    ("random", 3, 700, 300, 0, 40.0),   # everything near
    ("random", 3, 100, 300, 0, 5.0),    # the weight runs out before cap
]


@pytest.mark.parametrize("kind,P,K,cap,metric,sep", BATCH_POOLS)
def test_gated_batches_give_the_chains_picks_and_owners(kind, P, K, cap,
                                                        metric, sep):
    """gated_owners (the kernel's batches, their resolution, the cap and
    the gated passes) gives merge_plain's picks and owners, and counts its
    batches, live candidates and slots."""
    pool = _tensors(MP.POOLS[kind](P, K, 200 + K))
    pool[0][0, :] = 0.0                 # an empty row
    picks, owner = TM.greedy_owners(*pool, sep, cap, metric)
    gp, go, stats = TM.gated_owners(*pool, sep, cap, metric)
    assert torch.equal(gp, picks) and torch.equal(go, owner)
    st = dict(zip(TM.STATS, stats.T))
    assert int(st["slots"][0]) == 0 and int(st["batches"][0]) == 0
    assert torch.equal(st["slots"], (picks >= 0).sum(1))
    assert torch.equal(st["live"], (pool[0] > 0).sum(1))
    # a batch takes up to BATCH positions: at least slots / BATCH batches
    assert bool((st["batches"] * TM.BATCH >= st["slots"]).all())
    if sep == 1.0:
        assert torch.equal(st["unbounded"], st["live"])
    if kind == "outliers":
        assert int(st["unbounded"].max()) > 0


def test_gated_batches_on_weight_ties():
    """Exact weight ties throughout (the pick order breaks them by index):
    the batches give the chain's picks and owners."""
    pool = _tensors(MP.random_pool(4, 500, 9))
    pool[0] = torch.where(pool[0] > 0, torch.round(pool[0] * 2) / 2 + 0.5,
                          pool[0])
    picks, owner = TM.greedy_owners(*pool, 5.0, 200, 0)
    gp, go, _ = TM.gated_owners(*pool, 5.0, 200, 0)
    assert torch.equal(gp, picks) and torch.equal(go, owner)


def test_make_problem_shapes():
    """make_problem's draws: three quarters of the slots live, the last 3
    measurements padding, covariances positive definite."""
    from phdslam_tpu_torch.config import load_config
    cfg = load_config("cfg/ackerman_synth.cfg")
    pose, gm, z = MP.make_problem(np.random.default_rng(1), cfg, 8, 16, 10,
                                  "cpu")
    assert pose.shape == (8, 6) and gm.w.shape == (8, 16)
    assert (gm.w[:, :12] > 0).all() and (gm.w[:, 12:] == 0).all()
    assert (gm.c00 * gm.c11 - gm.c01 ** 2 > 0).all()
    assert z.count == 7 and z.rb.shape == (10, 2)

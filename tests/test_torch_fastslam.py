"""The port's FastSLAM (filter_type = 2) against ``phdslam_tpu.filter.
fastslam`` on the CPU: the auction's plain version, ``fastslam_update`` in
both association modes, ``test_fastslam.py``'s cases, and three whole
``slam_step``s on JAX's replayed draws.

Tolerances: the auction's columns and the FastSLAM counters (weights) and
slot order exactly; means and covariances rtol 2e-4 / atol 1e-6 (float32
Kalman terms on both sides); ``dw`` rtol 1e-5 (its sums over (M, F) run in
another order). ``fastslam_update``'s comparisons first check that both
sides chose the same assignment, so a near-tie flip shows as that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.filter import fastslam as JF
from phdslam_tpu.filter import step as JS
from phdslam_tpu.filter import update as JU
from phdslam_tpu.filter.state import Gaussian2DMixture as JG2
from phdslam_tpu.filter.state import Measurements as JMeas
from phdslam_tpu.filter.state import SlamState as JState
from phdslam_tpu.ops.linalg import wrap_angle as j_wrap
from phdslam_tpu.simdata import generate_run, make_scenario
from phdslam_tpu_torch.bridge import state_from_numpy
from phdslam_tpu_torch.config import SlamConfig as TConfig
from phdslam_tpu_torch.filter import fastslam as TF
from phdslam_tpu_torch.filter import step as TS
from phdslam_tpu_torch.filter.state import Gaussian2DMixture as TG2
from phdslam_tpu_torch.filter.state import Measurements as TMeas
from phdslam_tpu_torch.kernels import auction as A

torch.set_num_threads(1)

G2 = ("w", "mx", "my", "c00", "c01", "c11")
MAP_TOL = dict(rtol=2e-4, atol=1e-6)


def _fs_cfg(tiny_cfg, **kw):
    return tiny_cfg.replace(filterType=2, **kw)


# ------------------------------------------------------------ auction --

def _auction_case(rng, m=12, f=30):
    """test_fastslam.py's scipy case: 60 % of the pairs gated out, one
    private value on the diagonal of the no-match columns. Returns (raw
    benefit [m, f], private value, full benefit [m, f + m])."""
    ben = rng.normal(size=(m, f)) * 3.0
    ben = np.where(rng.random((m, f)) < 0.6, JF._NEG, ben).astype(np.float32)
    pv = float(rng.normal() - 2.0)
    return ben, pv, _full(ben, pv)


def _full(ben, pv):
    """The JAX side's benefit: the private columns concatenated as
    phdslam_tpu/filter/fastslam.py builds them (:220-224)."""
    m = ben.shape[-2]
    dummy = np.where(np.eye(m, dtype=bool), np.float32(pv),
                     np.float32(JF._NEG))
    dummy = np.broadcast_to(dummy, ben.shape[:-1] + (m,))
    return np.concatenate([ben, dummy], axis=-1).astype(np.float32)


def _assign(ben, pv, budget=None):
    """The port's auction_assign (plain on the CPU) on raw benefits."""
    ben = np.asarray(ben, np.float32)
    budget = 128 * (ben.shape[-1] + ben.shape[-2]) if budget is None \
        else budget
    col, iters = A.auction_assign(torch.as_tensor(ben), pv, budget)
    assert col.dtype == torch.int32 and iters.dtype == torch.int32
    return col.numpy(), iters.numpy()


@pytest.mark.parametrize("trial", range(5))
def test_auction_plain_matches_jax_and_scipy(trial):
    """The port's auction_assign_plain on the raw benefit gives JAX's
    _auction_rows columns on the concatenated one exactly, within 2e-3
    span m of scipy's optimum."""
    from scipy.optimize import linear_sum_assignment
    rng = np.random.default_rng(0)
    for _ in range(trial + 1):
        ben, pv, full = _auction_case(rng)
    m = full.shape[0]
    ref = np.asarray(JF._auction_rows(jnp.asarray(full)))
    col, iters = _assign(ben[None], pv)
    col = col[0]
    np.testing.assert_array_equal(col, ref)
    got = full[np.arange(m), col].sum()
    rows, cols = linear_sum_assignment(-full)
    opt = full[rows, cols].sum()
    span = np.ptp(full[full > JF._NEG / 2])
    assert got <= opt + 1e-6
    assert opt - got <= 2e-3 * span * m + 1e-6
    assert len(set(col.tolist())) == m and 0 < int(iters[0]) < 128 * 42


def test_auction_all_private_columns():
    m, f = 4, 6
    ben = np.full((m, f), JF._NEG, np.float32)
    ref = np.asarray(JF._auction_rows(jnp.asarray(_full(ben, -3.0))))
    got, iters = _assign(ben[None], -3.0)
    np.testing.assert_array_equal(got[0], ref)
    np.testing.assert_array_equal(got[0], f + np.arange(m))
    assert int(iters[0]) == 1


def test_auction_batch_equals_per_particle_calls():
    """Particles that converge in one round (only private columns live)
    beside particles that take many: the batched plain version freezes each
    finished particle, so every particle's columns and rounds equal a call
    on it alone, and the columns equal JAX's vmapped _auction_rows."""
    rng = np.random.default_rng(3)
    cases = [_auction_case(rng) for _ in range(6)]
    ben = np.stack([c[0] for c in cases])
    ben[[1, 4]] = JF._NEG
    pv = cases[0][1]
    budget = 128 * 42
    col, iters = _assign(ben, pv, budget)
    assert int(iters[1]) == int(iters[4]) == 1
    assert int(iters.max()) > 2
    for p in range(len(cases)):
        c, it = _assign(ben[p:p + 1], pv, budget)
        np.testing.assert_array_equal(c[0], col[p])
        assert int(it[0]) == int(iters[p])
    ref = np.asarray(jax.vmap(JF._auction_rows)(jnp.asarray(_full(ben, pv))))
    np.testing.assert_array_equal(col, ref)


def test_auction_plain_nan_ends_at_the_budget_in_range():
    """A NaN in the clamped benefit (the rounds' core, _rounds, as the
    kernel's bid round sees it): its row bids NaN, which never wins, so the
    rounds end at the budget; every owner stays a row or -1 and the column
    readout falls back to the private columns, in range."""
    rng = np.random.default_rng(5)
    full = np.stack([_auction_case(rng)[2] for _ in range(3)])
    clamped, eps, live = A.clamp_benefit(torch.as_tensor(full))
    clamped[1, 2, 5] = float("nan")
    owner, iters, _, _, _ = A._rounds(clamped, eps, 200,
                                      clamped.new_zeros(clamped.shape[::2]))
    assert int(iters[1]) == 200 and int(iters[0]) < 200
    assert int(owner.min()) >= -1 and int(owner.max()) < 12
    col = A.col_of_row(owner, clamped, live)
    assert int(col.min()) >= 0 and int(col.max()) < full.shape[2]


def _raw_cases(kind, rng):
    """Raw [P, M, F] benefits for the JAX comparison: (benefit, pv)."""
    P, M, F = 5, 10, 24
    ben = np.where(rng.random((P, M, F)) < 0.5, JF._NEG,
                   rng.normal(size=(P, M, F)) * 3.0).astype(np.float32)
    if kind == "private_only":
        ben[:] = JF._NEG
    elif kind == "padded":                  # z_valid false: rows gated out
        ben[:, 7:] = JF._NEG
    elif kind == "nan":                     # a NaN pose upstream
        ben[0, 2, 3] = np.nan
        ben[1] = np.nan
        ben[2, :, 5] = np.nan
        ben[3, 4, :] = np.nan
    elif kind == "all_gated":
        ben[2] = JF._NEG
    return ben, float(rng.normal() - 2.0)


@pytest.mark.parametrize("kind", ["random", "private_only", "padded", "nan",
                                  "all_gated"])
def test_auction_assign_matches_jax(kind):
    """auction_assign_plain on raw benefits [P, M, F] and one private value
    against JAX's jax.vmap(_auction_rows) on the concatenated benefit:
    the columns exactly. A NaN in the raw benefit is not live, so it is
    clamped to the floor on both sides."""
    ben, pv = _raw_cases(kind, np.random.default_rng(
        ["random", "private_only", "padded", "nan", "all_gated"].index(kind)))
    ref = np.asarray(jax.vmap(JF._auction_rows)(jnp.asarray(_full(ben, pv))))
    col, iters = _assign(ben, pv)
    np.testing.assert_array_equal(col, ref)
    M, F = ben.shape[1:]
    if kind == "private_only":
        np.testing.assert_array_equal(col, np.broadcast_to(F + np.arange(M),
                                                           col.shape))
        assert (iters == 1).all()
    if kind == "padded":
        np.testing.assert_array_equal(
            col[:, 7:], np.broadcast_to(F + np.arange(7, M), col[:, 7:].shape))
    if kind == "all_gated":
        np.testing.assert_array_equal(col[2], F + np.arange(M))


def _kernel_prologue(ben, pv):
    """csrc/auction.cu::assign_kernel's prologue on one particle, each
    operation an IEEE float32 one as the kernel does it: (eps, floor)."""
    f32 = np.float32
    live_above = f32(JF._NEG / 2)
    vals = np.concatenate([ben.ravel(), [f32(pv)]]).astype(f32)
    with np.errstate(invalid="ignore"):
        live = vals[vals > live_above]
    hi = live.max() if live.size else f32(-np.inf)
    lo = live.min() if live.size else f32(np.inf)
    hi = hi if np.isfinite(hi) else f32(0.0)
    lo = lo if np.isfinite(lo) else f32(0.0)
    d = f32(hi - lo)
    span = f32(1.0) if d < f32(1.0) else d
    floor = f32(f32(lo - f32(f32(4.0) * span)) - f32(1.0))
    return f32(f32(1e-3) * span), floor


def test_auction_prologue_is_the_clamp_bit_for_bit():
    """The kernel's prologue (eps, floor), rounded op by op in float32 with
    the scalars cast as PyTorch casts them, equals clamp_benefit's on the
    concatenated benefit, bit for bit: spans from below 1 to 1e29, values
    at _NEG / 2's edge, NaN, +inf, nothing live."""
    rng = np.random.default_rng(11)
    P, M, F = 12, 6, 9
    ben = (rng.normal(size=(P, M, F))
           * np.logspace(-3, 29, P)[:, None, None]).astype(np.float32)
    ben[rng.random((P, M, F)) < 0.4] = JF._NEG
    ben[3, 0, 0] = np.float32(JF._NEG / 2)          # not live: not above
    ben[4, 1, 1] = np.nextafter(np.float32(JF._NEG / 2), np.float32(0))
    ben[5, 2, 2] = np.nan
    ben[6, 3, 3] = np.inf
    ben[7] = JF._NEG                                # only pv live
    ben[8, :, :4] = -4.0e29
    for pv in (-2.5, -4.9e29, JF._NEG):             # pv not live last
        clamped, eps, _ = A.clamp_benefit(torch.as_tensor(_full(ben, pv)))
        floor = clamped.amin((1, 2)).numpy()
        for p in range(P):
            k_eps, k_floor = _kernel_prologue(ben[p], pv)
            # the private columns off the diagonal hold the floor
            assert np.float32(eps[p]).tobytes() == k_eps.tobytes(), (pv, p)
            assert floor[p].tobytes() == k_floor.tobytes(), (pv, p)


@pytest.mark.parametrize("budget", [0, 1, 2])
def test_auction_assign_readout_at_the_budget(budget):
    """A budget the rows cannot finish in: auction_assign_plain equals the
    old composition (concatenate, clamp_benefit, the rounds, col_of_row)
    column for column, and the rows left unassigned take their best column
    only they can win."""
    rng = np.random.default_rng(21 + budget)
    ben = np.stack([_auction_case(rng, m=8, f=6)[0] for _ in range(4)])
    ben[0, :, 1] = np.float32(JF._NEG)
    ben[0, 3, 1] = 2.0                              # column 1: row 3 alone
    pv = -1.5
    full = torch.as_tensor(_full(ben, pv))
    clamped, eps, live = A.clamp_benefit(full)
    owner, iters, _, assigned, _ = A._rounds(
        clamped, eps, budget, clamped.new_zeros(clamped.shape[::2]))
    old = A.col_of_row(owner, clamped, live)
    col, it = _assign(ben, pv, budget)
    np.testing.assert_array_equal(col, old.numpy())
    np.testing.assert_array_equal(it, iters.numpy())
    assert (it == budget).all() and (~assigned).any()
    left = ~assigned.numpy()
    assert ((col >= 0) & (col < 14)).all()
    # an unassigned row's column is live for it and for no other row
    live_n = live.numpy().sum(1)
    for p, m in zip(*np.nonzero(left)):
        assert live[p, m, col[p, m]] and live_n[p, col[p, m]] == 1


# ----------------------------------------------------- fastslam_update --

def _inputs(cfg, seed, P=8):
    """Seeded poses near the origin, maps with integer counters (dead
    slots among them, a few landmarks out of view) and measurements of the
    landmarks plus clutter (the last slots padded): (numpy dict of map
    channels, pose, z_rb, z_valid)."""
    rng = np.random.default_rng(seed)
    F, M = cfg.maxFeatures, cfg.maxMeasurements
    pose = np.zeros((P, 6), np.float32)
    pose[:, :2] = rng.normal(0, 0.15, (P, 2))
    pose[:, 2] = rng.normal(0, 0.02, P)
    n_lm = F - 4
    r = rng.uniform(2.0, 9.0, n_lm)
    b = rng.uniform(-1.3, 1.3, n_lm)
    r[:3] = rng.uniform(14.0, 20.0, 3)               # out of view
    lm = np.stack([r * np.cos(b), r * np.sin(b)], 1)
    w = rng.integers(0, 5, (P, F)).astype(np.float32)
    w[:, n_lm:] = 0.0
    mean = lm[None] + rng.normal(0, 0.2, (P, n_lm, 2))
    ch = dict(w=w, mx=np.zeros((P, F)), my=np.zeros((P, F)),
              c00=np.ones((P, F)), c01=np.zeros((P, F)), c11=np.ones((P, F)))
    live = w[:, :n_lm] > 0
    ch["mx"][:, :n_lm] = np.where(live, mean[..., 0], 0.0)
    ch["my"][:, :n_lm] = np.where(live, mean[..., 1], 0.0)
    ch["c00"][:, :n_lm] = np.where(live, rng.uniform(0.1, 0.5, (P, n_lm)),
                                   1.0)
    ch["c11"][:, :n_lm] = np.where(live, rng.uniform(0.1, 0.5, (P, n_lm)),
                                   1.0)
    ch["c01"][:, :n_lm] = np.where(live, rng.uniform(-0.03, 0.03,
                                                     (P, n_lm)), 0.0)
    ch = {k: v.astype(np.float32) for k, v in ch.items()}
    seen = rng.choice(np.arange(3, n_lm), size=M - 3, replace=False)
    z = np.zeros((M, 2), np.float32)
    z[:M - 3, 0] = r[seen] + rng.normal(0, 0.1, M - 3)
    z[:M - 3, 1] = b[seen] + rng.normal(0, 0.01, M - 3)
    z[M - 3] = [rng.uniform(1.0, 9.0), rng.uniform(-1.4, 1.4)]   # clutter
    valid = np.arange(M) < M - 2
    return ch, pose, z, valid


def _jax_assignment(pose, gm, z_rb, z_valid, cfg):
    """JAX's association for these inputs: the lines of
    phdslam_tpu/filter/fastslam.py::fastslam_update (:191-243) with the
    JAX package's kalman_preupdate and _auction_rows."""
    F, M = gm.w.shape[1], z_rb.shape[0]
    pre = JU.kalman_preupdate(pose, gm, cfg)
    innov_r = z_rb[None, :, None, 0] - pre.r[:, None, :]
    innov_b = j_wrap(z_rb[None, :, None, 1] - pre.bearing[:, None, :])
    dist = jnp.maximum(innov_r * innov_r * pre.si00[:, None, :]
                       + 2.0 * innov_r * innov_b * pre.si01[:, None, :]
                       + innov_b * innov_b * pre.si11[:, None, :], 0.0)
    ln_n = -0.5 * dist - JU.LOG_2PI - 0.5 * pre.log_det_s[:, None, :]
    in_fov = (pre.rclass == 1) & gm.valid
    gate_ok = (dist <= cfg.fastslamGate) & in_fov[:, None, :] \
        & z_valid[None, :, None]
    log_pd, log_qd = np.log(cfg.pd), np.log(max(1.0 - cfg.pd, 1e-12))
    log_kappa = float(np.log(max(cfg.clutterDensity, 1e-12)))
    benefit = jnp.where(gate_ok, ln_n + float(log_pd - log_qd), JF._NEG)
    if cfg.fastslamAssoc == 1:
        dummy = jnp.where(jnp.eye(M, dtype=bool), log_kappa, JF._NEG)
        full = jnp.concatenate([benefit, jnp.broadcast_to(
            dummy, (gm.w.shape[0], M, M))], axis=2)
        col = jax.vmap(JF._auction_rows)(full)
        return np.asarray((col < F) & z_valid[None]), np.asarray(
            jnp.minimum(col, F - 1))
    best_f = jnp.argmax(benefit, axis=2)
    best_v = jnp.max(benefit, axis=2)
    assigned = (best_v > log_kappa) & z_valid[None, :]
    onehot = (best_f[:, :, None] == jnp.arange(F)) & assigned[:, :, None]
    winner = jnp.argmax(jnp.where(onehot, best_v[:, :, None], JF._NEG), 1)
    keep = jnp.take_along_axis(winner, jnp.minimum(best_f, F - 1), 1) \
        == jnp.arange(M)[None, :]
    return np.asarray(assigned & keep), np.asarray(best_f)


def _both(cfg, ch, pose, z, valid):
    jgm = JG2(**{k: jnp.asarray(v) for k, v in ch.items()})
    tgm = TG2(**{k: torch.as_tensor(v) for k, v in ch.items()})
    jout = JF.fastslam_update(jnp.asarray(pose), jgm, jnp.asarray(z),
                              jnp.asarray(valid), cfg)
    tout = TF.fastslam_update(torch.as_tensor(pose), tgm, torch.as_tensor(z),
                              torch.as_tensor(valid), cfg)
    return jgm, tgm, jout, tout


def _assert_same_update(jout, tout, tag=""):
    (jgm, jdw), (tgm, tdw) = jout, tout
    # counters and the slot order exactly: the same features kept in the
    # same slots
    np.testing.assert_array_equal(tgm.w.numpy(), np.asarray(jgm.w),
                                  err_msg=f"{tag} w")
    for k in G2[1:]:
        np.testing.assert_allclose(getattr(tgm, k).numpy(),
                                   np.asarray(getattr(jgm, k)),
                                   err_msg=f"{tag} {k}", **MAP_TOL)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), rtol=1e-5,
                               err_msg=f"{tag} dw")


@pytest.mark.parametrize("assoc", [0, 1])
@pytest.mark.parametrize("seed", [1, 2])
def test_fastslam_update_matches_jax(tiny_cfg, assoc, seed):
    cfg = _fs_cfg(tiny_cfg, fastslamAssoc=assoc, stdRange=0.3)
    ch, pose, z, valid = _inputs(cfg, seed)
    jgm, tgm, jout, tout = _both(cfg, ch, pose, z, valid)
    # the assignment first: both sides paired the same measurements with
    # the same features (a near-tie flip would show here, not as a mean)
    pre, ir, ib, benefit, in_fov = TF.association_terms(
        torch.as_tensor(pose), tgm, torch.as_tensor(z),
        torch.as_tensor(valid), cfg)
    t_assigned, t_feat = TF.associate(benefit, torch.as_tensor(valid), cfg)
    j_assigned, j_feat = _jax_assignment(jnp.asarray(pose), jgm,
                                         jnp.asarray(z), jnp.asarray(valid),
                                         cfg)
    np.testing.assert_array_equal(t_assigned.numpy(), j_assigned)
    np.testing.assert_array_equal(
        np.where(j_assigned, t_feat.numpy(), -1),
        np.where(j_assigned, j_feat, -1))
    assert j_assigned.sum() >= 3 and (~j_assigned[:, :-2]).any()
    assert (ch["w"] == 0).any() and bool((~in_fov & tgm.valid).any())
    _assert_same_update(jout, tout)


# ------------------------------------- test_fastslam.py's cases, ported --

def _one_landmark_map(cfg, P, **slots):
    F = cfg.maxFeatures
    ch = dict(w=np.zeros((P, F)), mx=np.zeros((P, F)), my=np.zeros((P, F)),
              c00=np.ones((P, F)), c01=np.zeros((P, F)), c11=np.ones((P, F)))
    for k, (idx, val) in slots.items():
        ch[k][:, idx] = val
    return {k: v.astype(np.float32) for k, v in ch.items()}


def _z(cfg, *rows):
    M = cfg.maxMeasurements
    z = np.zeros((M, 2), np.float32)
    valid = np.zeros((M,), bool)
    for i, r in enumerate(rows):
        z[i] = r
        valid[i] = True
    return z, valid


def test_ekf_update_matches_jax(tiny_cfg):
    """test_fastslam.py:83: one landmark (counter 3) and one measurement
    near it; the EKF update, the counter and dw as JAX's."""
    cfg = _fs_cfg(tiny_cfg)
    ch = _one_landmark_map(cfg, 1, w=(0, 3.0), mx=(0, 6.0), my=(0, 1.5),
                           c00=(0, 0.4), c01=(0, 0.1), c11=(0, 0.3))
    z, valid = _z(cfg, [6.3, np.arctan2(1.5, 6.0) + 0.02])
    _, _, jout, tout = _both(cfg, ch, np.zeros((1, 6), np.float32), z, valid)
    _assert_same_update(jout, tout)
    assert float(tout[0].w[0, 0]) == 4.0


def test_counter_decay_death_and_out_of_view(tiny_cfg):
    """test_fastslam.py:126: no measurements; the counter-3 landmark decays
    to 2, the counter-1 one dies (slot reset), out of view both stay."""
    cfg = _fs_cfg(tiny_cfg)
    z, valid = _z(cfg)
    pose = np.zeros((1, 6), np.float32)
    for far in (False, True):
        x = [1e4, 1e4] if far else [5.0, 7.0]
        ch = _one_landmark_map(cfg, 1, w=([0, 1], [1.0, 3.0]),
                               mx=([0, 1], x), c00=([0, 1], 0.2),
                               c11=([0, 1], 0.2))
        _, _, jout, tout = _both(cfg, ch, pose, z, valid)
        _assert_same_update(jout, tout, f"far={far}")
        w = np.sort(tout[0].w[0].numpy())[::-1]
        np.testing.assert_array_equal(w[:2], [3.0, 1.0] if far
                                      else [2.0, 0.0])


def test_birth_from_unmatched_measurement(tiny_cfg):
    """test_fastslam.py:151: an empty map and one measurement: one birth of
    counter 1 at the measured point, dw the clutter likelihood."""
    cfg = _fs_cfg(tiny_cfg)
    z, valid = _z(cfg, [4.0, 0.5])
    ch = _one_landmark_map(cfg, 1)
    _, _, jout, tout = _both(cfg, ch, np.zeros((1, 6), np.float32), z, valid)
    _assert_same_update(jout, tout)
    assert float(tout[0].w.sum()) == 1.0
    assert float(tout[1][0]) == pytest.approx(np.log(cfg.clutterDensity),
                                              rel=1e-4)


def test_weighting_prefers_the_consistent_pose(tiny_cfg):
    """test_fastslam.py:173: the particle without a yaw error scores
    higher."""
    cfg = _fs_cfg(tiny_cfg)
    pose = np.zeros((2, 6), np.float32)
    pose[1, 2] = 0.15
    ch = _one_landmark_map(cfg, 2, w=(0, 3.0), mx=(0, 8.0), c00=(0, 0.1),
                           c11=(0, 0.1))
    z, valid = _z(cfg, [8.0, 0.0])
    _, _, jout, tout = _both(cfg, ch, pose, z, valid)
    _assert_same_update(jout, tout)
    assert float(tout[1][0]) > float(tout[1][1])


def test_ml_and_auction_agree_when_unambiguous(tiny_cfg):
    """test_fastslam.py:190: two well-separated landmarks, a measurement of
    each: both modes give JAX's result and the same as each other."""
    ch = None
    outs = []
    for assoc in (1, 0):
        cfg = _fs_cfg(tiny_cfg, fastslamAssoc=assoc)
        ch = _one_landmark_map(cfg, 1, w=([0, 1], 2.0), mx=([0, 1], [5, 9]),
                               my=([0, 1], [0, 3]), c00=([0, 1], 0.3),
                               c11=([0, 1], 0.3))
        z, valid = _z(cfg, [5.0, 0.0], [np.hypot(9, 3), np.arctan2(3, 9)])
        _, _, jout, tout = _both(cfg, ch, np.zeros((1, 6), np.float32), z,
                                 valid)
        _assert_same_update(jout, tout, f"assoc={assoc}")
        outs.append(tout)
    np.testing.assert_allclose(outs[0][1].numpy(), outs[1][1].numpy(),
                               rtol=1e-5)
    np.testing.assert_array_equal(outs[0][0].w.numpy(), outs[1][0].w.numpy())


def test_fastslam_rejects_mixed_feature_model():
    """test_fastslam.py:323: the port's config refuses filter_type 2 with a
    mixed feature model too."""
    with pytest.raises(ValueError, match="feature_model"):
        TConfig(filterType=2, featureModel=2)
    TConfig(filterType=2, featureModel=0)


# ------------------------------------------------- three whole steps --

def _draws(key, cfg, n_pred):
    k_pred, _k_var, k_res = jax.random.split(key, 3)
    keys = jax.random.split(k_pred, max(int(cfg.subdividePredict), 1))
    normals = np.stack([np.asarray(jax.random.normal(k, (n_pred, 2),
                                                     jnp.float32))
                        for k in keys])
    u = np.asarray(jax.random.uniform(k_res, (cfg.n_particles,),
                                      jnp.float32))
    return torch.as_tensor(normals), torch.as_tensor(np.array(u))


@pytest.mark.parametrize("assoc", [0, 1])
def test_three_fastslam_steps_match_jax(tiny_cfg, assoc):
    """Three slam_steps at tiny_cfg with filter_type 2 on JAX's replayed
    draws (test_torch_step.py's pattern and tolerances: rtol 1e-4 / atol
    1e-5 on poses, weights and the aux values, resample indices exactly;
    the counters exactly, the other map channels rtol 2e-4 / atol 1e-4)."""
    cfg = _fs_cfg(tiny_cfg, fastslamAssoc=assoc, stdRange=0.25,
                  clutterRate=2.0)
    sc = make_scenario(np.random.default_rng(11), n_landmarks=12, n_steps=6,
                       clutter_rate=2.0)
    controls, meas = generate_run(np.random.default_rng(12), sc,
                                  control_noise=(0.05, 0.005))
    jstate = JState.create(cfg)
    tstate = state_from_numpy(jax.device_get(jstate))
    key = jax.random.PRNGKey(5)
    M = cfg.maxMeasurements
    tol = dict(rtol=1e-4, atol=1e-5)
    for t in range(3):
        key, sk = jax.random.split(key)
        ctrl = controls[t - 1] if t > 0 else np.zeros(2, np.float32)
        rb = np.zeros((M, 2), np.float32)
        k = min(len(meas[t]), M)
        rb[:k] = meas[t][:k]
        valid = np.arange(M) < k
        lab = np.zeros((M,), np.int32)
        jstate, jaux = JS.slam_step(
            jstate, sk, (jnp.float32(ctrl[0]), jnp.float32(ctrl[1])),
            JMeas(rb=jnp.asarray(rb), label=jnp.asarray(lab),
                  valid=jnp.asarray(valid)),
            jnp.float32(cfg.dt), jnp.asarray(t > 0), cfg)
        tstate, taux = TS.slam_step(
            tstate, (float(ctrl[0]), float(ctrl[1])),
            TMeas.from_numpy(rb, lab, valid), float(cfg.dt), t > 0, cfg,
            noise=_draws(sk, cfg, cfg.n_particles))
        j = jax.device_get(jstate)
        np.testing.assert_allclose(tstate.pose.numpy(), j.pose, **tol)
        np.testing.assert_allclose(tstate.log_weights.numpy(),
                                   j.log_weights, **tol)
        np.testing.assert_array_equal(tstate.resample_idx.numpy(),
                                      j.resample_idx)
        np.testing.assert_array_equal(tstate.map_static.w.numpy(),
                                      j.map_static.w, err_msg=f"step {t}")
        for name in G2[1:]:
            np.testing.assert_allclose(
                getattr(tstate.map_static, name).numpy(),
                getattr(j.map_static, name), err_msg=f"step {t} {name}",
                rtol=2e-4, atol=1e-4)
        for name in ("expected_pose", "neff", "log_lik"):
            np.testing.assert_allclose(getattr(taux, name).numpy(),
                                       np.asarray(getattr(jaux, name)),
                                       err_msg=name, **tol)
        assert bool(taux.resampled) == bool(jaux.resampled)
    assert float(tstate.map_static.w.max()) >= 2.0


def test_predicted_state_is_the_steps_prediction(tiny_cfg):
    """predicted_state on a step's noise gives the poses slam_step moves
    the particles to before its update (shotgun copies included), and
    matches JAX's predicted_state on the same draws."""
    cfg = _fs_cfg(tiny_cfg, nPredictParticles=2)
    jstate = JState.create(cfg)
    tstate = state_from_numpy(jax.device_get(jstate))
    key = jax.random.PRNGKey(2)
    noise = _draws(key, cfg, 2 * cfg.n_particles)
    pred = TS.predicted_state(tstate, (1.0, 0.1), 1.0, True, cfg, noise)
    jpred = JS.predicted_state(jstate, key, (jnp.float32(1.0),
                                             jnp.float32(0.1)),
                               jnp.float32(1.0), jnp.asarray(True), cfg)
    assert pred.n_particles == 2 * cfg.n_particles
    np.testing.assert_allclose(pred.pose.numpy(), np.asarray(jpred.pose),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pred.log_weights.numpy(),
                               np.asarray(jpred.log_weights), rtol=1e-6)

"""The port's 4-D machinery and the mixed static + dynamic update against
``phdslam_tpu/filter/update4.py``.

JAX runs on the CPU, where ``phd_update_mixed`` takes its XLA route (the
[P, M, F] tensors, top_k and gathers, the XLA ``greedy_merge4``); the port
runs its only route, the kernel branch, whose wrappers take the plain
PyTorch versions on CPU tensors. The same numpy inputs go through both, in
float32.

Tolerances: rtol 2e-4 / atol 1e-5 unless a test states otherwise (float32
through the Kalman terms, the normalisers and the merge moments). The XLA
route normalises in log space (exp(lw - log norm)), the kernels as e / norm,
and the merge's moments are taken in one pass centred on the pick against
XLA's two passes: that, the bearing wrap and the summation order account
for the last digits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.filter import update4 as J4
from phdslam_tpu.filter.state import Gaussian2DMixture as JG2
from phdslam_tpu.filter.state import Gaussian4DMixture as JG4
from phdslam_tpu.ops.linalg import wrap_angle as j_wrap
from phdslam_tpu_torch.filter import update4 as T4
from phdslam_tpu_torch.filter.state import Gaussian2DMixture as TG2
from phdslam_tpu_torch.filter.state import Gaussian4DMixture as TG4
from phdslam_tpu_torch.kernels import merge4 as TM4
from phdslam_tpu_torch.kernels import select4 as TS4

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=1e-5)


def _t(a, dtype=np.float32):
    return torch.as_tensor(np.array(a, dtype))


def _close(got, ref, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               err_msg=msg, **tol)


@pytest.fixture(scope="module")
def mixed_cfg():
    """tests/test_mixed.py's mixed configuration (the shipped mixed knobs
    at the tiny shape)."""
    from phdslam_tpu.config import load_config
    return load_config("cfg/mixed_synth.cfg").replace(
        n_particles=8, maxFeatures=16, maxMeasurements=8, y0=0.0,
        clutterRate=2.0)


def _cov4(rng, shape, scale=0.4):
    """Random symmetric positive definite 4x4 stacks as [..., 10, F]
    channels (S4 order), shape = (..., F)."""
    a = rng.normal(size=shape + (4, 4)) * scale
    cov = a @ np.swapaxes(a, -1, -2) + 0.2 * np.eye(4)
    ch = [cov[..., i, j] for i in range(4) for j in range(i, 4)]
    return np.stack(ch, axis=-2).astype(np.float32)


def _gm4(rng, P, F, live=0.6, box=8.0):
    w = ((rng.uniform(size=(P, F)) < live)
         * rng.uniform(0.1, 1.0, (P, F))).astype(np.float32)
    mean = np.concatenate([rng.uniform(-box, box, (P, 2, F)),
                           rng.normal(0, 0.5, (P, 2, F))], 1)
    return dict(w=w, mean_channels=mean.astype(np.float32),
                cov_channels=_cov4(rng, (P, F)))


def _gm2(rng, P, F, live=0.5, box=8.0):
    w = ((rng.uniform(size=(P, F)) < live)
         * rng.uniform(0.1, 1.0, (P, F))).astype(np.float32)
    mean = rng.uniform(-box, box, (P, F, 2)).astype(np.float32)
    c00 = rng.uniform(0.1, 0.5, (P, F)).astype(np.float32)
    c11 = rng.uniform(0.1, 0.5, (P, F)).astype(np.float32)
    c01 = (0.3 * np.sqrt(c00 * c11)
           * rng.uniform(-1, 1, (P, F))).astype(np.float32)
    return dict(w=w, mx=mean[..., 0], my=mean[..., 1], c00=c00, c01=c01,
                c11=c11)


def _both4(d):
    return (JG4(**{k: jnp.asarray(v) for k, v in d.items()}),
            TG4(**{k: _t(v) for k, v in d.items()}))


def _both2(d):
    return (JG2(**{k: jnp.asarray(v) for k, v in d.items()}),
            TG2(**{k: _t(v) for k, v in d.items()}))


def _pose(rng, P):
    return np.concatenate([rng.uniform(-1, 1, (P, 3)) * [1, 1, 0.3],
                           np.zeros((P, 3))], 1).astype(np.float32)


def _z(rng, M):
    return np.stack([rng.uniform(0.5, 9.0, M), rng.uniform(-1.2, 1.2, M)],
                    1).astype(np.float32)


# ------------------------------------------------------------- helpers --

def test_s4_and_chol4_solve_sq_match_jax(rng):
    c = _cov4(rng, (6, 12))
    d = rng.normal(size=(6, 4, 12)).astype(np.float32)
    for i in range(4):
        for j in range(4):
            np.testing.assert_array_equal(
                T4.s4(_t(c), i, j).numpy(), np.asarray(J4.s4(c, i, j)))
    _close(T4.chol4_solve_sq(_t(c), _t(d)), J4.chol4_solve_sq(
        jnp.asarray(c), jnp.asarray(d)), dict(rtol=1e-5, atol=1e-6))


def test_kalman_preupdate4_matches_jax(mixed_cfg, rng):
    P, F = 8, 16
    jg, tg = _both4(_gm4(rng, P, F))
    pose = _pose(rng, P)
    ref = J4.kalman_preupdate4(jnp.asarray(pose), jg, mixed_cfg)
    got = T4.kalman_preupdate4(_t(pose), tg, mixed_cfg)
    assert (np.asarray(ref.rclass) == 1).any()
    for name in ref._fields:
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        if name == "rclass":
            np.testing.assert_array_equal(g, r)
        else:
            _close(g, r, dict(rtol=2e-5, atol=2e-6), name)


@pytest.mark.parametrize("informed", [False, True])
def test_birth4_channels_match_jax(mixed_cfg, rng, informed):
    P, M = 6, 5
    pose = _pose(rng, P)
    z = _z(rng, M)
    vel_np = None
    if informed:
        vel_np = (rng.normal(size=(P, M)).astype(np.float32),
                  rng.normal(size=(P, M)).astype(np.float32),
                  rng.uniform(0.05, 0.3, (P, M)).astype(np.float32))
    rm, rc = J4.birth4_channels(
        jnp.asarray(pose)[:, None, :], jnp.asarray(z)[None], mixed_cfg,
        vel=None if vel_np is None else tuple(map(jnp.asarray, vel_np)))
    gm, gc = T4.birth4_channels(
        _t(pose)[:, None, :], _t(z)[None], mixed_cfg,
        vel=None if vel_np is None else tuple(map(_t, vel_np)))
    for g, r in zip(gm + gc, rm + rc):
        _close(np.broadcast_to(g.numpy(), (P, M)),
               np.broadcast_to(np.asarray(r), (P, M)))


def test_informed_birth_velocity_matches_jax(mixed_cfg, rng):
    """prev_measurement_world then informed_birth_velocity, with a previous
    set that half matches (its points moved 0.3 m), one invalid slot and a
    zero dt (no match at all)."""
    cfg = mixed_cfg.replace(birthVelocityInit=True)
    P, M = 6, 8
    pose_prev, pose = _pose(rng, P), _pose(rng, P)
    zp = _z(rng, M)
    zp_valid = np.arange(M) != 3
    z = zp + rng.normal(0, 0.05, zp.shape).astype(np.float32)
    z[M // 2:] = _z(rng, M - M // 2)
    z_valid = np.arange(M) < 7
    zw_j = J4.prev_measurement_world(jnp.asarray(pose_prev), jnp.asarray(zp),
                                     jnp.asarray(zp_valid))
    zw_t = T4.prev_measurement_world(_t(pose_prev), _t(zp),
                                     torch.as_tensor(zp_valid))
    _close(zw_t, zw_j)
    for dt in (1.0, 0.0):
        ref = J4.informed_birth_velocity(
            jnp.asarray(pose), jnp.asarray(z), jnp.asarray(z_valid), zw_j,
            jnp.asarray(zp_valid), jnp.float32(dt), cfg)
        got = T4.informed_birth_velocity(
            _t(pose), _t(z), torch.as_tensor(z_valid), zw_t,
            torch.as_tensor(zp_valid), dt, cfg)
        for g, r in zip(got, ref):
            _close(g, r, msg=f"dt {dt}")
        matched = got[2].numpy() < cfg.covVxBirth
        # dt 1: the moved points match, the new ones do not; dt 0: none
        assert matched.any() == (dt > 0) and not matched.all()


def test_cv_predict4_matches_jax(mixed_cfg, rng):
    jg, tg = _both4(_gm4(rng, 5, 12))
    scale = rng.uniform(0.5, 1.0, (5, 12)).astype(np.float32)
    ref = J4.cv_predict4(jg, mixed_cfg, 0.7, w_scale=jnp.asarray(scale))
    got = T4.cv_predict4(tg, mixed_cfg, 0.7, w_scale=_t(scale))
    for name in ("w", "mean_channels", "cov_channels"):
        _close(getattr(got, name), getattr(ref, name), msg=name)


@pytest.mark.parametrize("feature_model", [1, 2])
def test_jump_markov_scales_match_jax(mixed_cfg, rng, feature_model):
    """Both branches: DYNAMIC (velocity-dependent survival) and MIXED
    (jump-Markov logistic); tau and beta set so that the logistic is not
    saturated."""
    cfg = mixed_cfg.replace(featureModel=feature_model, tau=0.5, beta=3.0)
    jg, tg = _both4(_gm4(rng, 5, 12))
    ref = J4.jump_markov_scales(jg, cfg)
    got = T4.jump_markov_scales(tg, cfg)
    for g, r in zip(got, ref):
        _close(g, r, dict(rtol=1e-5, atol=1e-6))


def test_gather_selected4_matches_jax(mixed_cfg, rng):
    P, F, M, k1 = 6, 16, 5, 4
    jg, tg = _both4(_gm4(rng, P, F))
    pose, z = _pose(rng, P), _z(rng, M)
    pre_j = J4.kalman_preupdate4(jnp.asarray(pose), jg, mixed_cfg)
    pre_t = T4.kalman_preupdate4(_t(pose), tg, mixed_cfg)
    f_sel = rng.integers(0, F, (P, M, k1)).astype(np.int32)
    ref = J4.gather_selected4(pre_j, jg, jnp.asarray(z), jnp.asarray(f_sel))
    got = T4.gather_selected4(pre_t, tg, _t(z), torch.as_tensor(f_sel))
    for g, r in zip(got, ref):
        assert g.shape == (P, r.shape[1], M, k1)
        _close(g, r)


# ------------------------------------------------------- select4 kernel --

def _xla_select4(cfg, jg, pre, z_rb, k1):
    """update4.py's XLA formulation of the dynamic detection terms (every
    measurement valid, unlabeled), then top_k and gather_selected4."""
    innov_r = z_rb[None, :, None, 0] - pre.r[:, None, :]
    innov_b = j_wrap(z_rb[None, :, None, 1] - pre.bearing[:, None, :])
    dist4 = (innov_r ** 2 * pre.si00[:, None, :]
             + 2 * innov_r * innov_b * pre.si01[:, None, :]
             + innov_b ** 2 * pre.si11[:, None, :])
    dist4 = jnp.maximum(dist4, 0.0)
    from phdslam_tpu.ops.linalg import safe_log
    lw4 = (safe_log(pre.pd)[:, None, :] + safe_log(jg.w)[:, None, :]
           - 0.5 * dist4 - J4.LOG_2PI - 0.5 * pre.log_det_s[:, None, :])
    lw4 = jnp.where((pre.rclass == 1)[:, None, :], lw4, -jnp.inf)
    e = jnp.exp(lw4)
    w_sel, f_sel = jax.lax.top_k(e, k1)
    mean, cov = J4.gather_selected4(pre, jg, z_rb, f_sel)
    return jnp.sum(e, axis=-1), w_sel, f_sel, mean, cov


@pytest.mark.parametrize("P,F,M,k1", [(8, 16, 8, 8), (7, 20, 5, 3)])
def test_plain_select4_matches_xla(mixed_cfg, rng, P, F, M, k1):
    jg, tg = _both4(_gm4(rng, P, F))
    pose, z = _pose(rng, P), _z(rng, M)
    pre_j = J4.kalman_preupdate4(jnp.asarray(pose), jg, mixed_cfg)
    pre_t = T4.kalman_preupdate4(_t(pose), tg, mixed_cfg)
    r_sum, r_w, r_f, r_mean, r_cov = [
        np.asarray(a) for a in _xla_select4(mixed_cfg, jg, pre_j,
                                            jnp.asarray(z), k1)]
    sum_exp, w_sel, mean, cov = TS4.fused_update_select4(_t(z), pre_t, tg,
                                                         k1=k1)
    assert mean.shape == (P, 4, M, k1) and cov.shape == (P, 10, M, k1)
    _close(sum_exp, r_sum, dict(rtol=1e-4, atol=1e-9))
    _close(w_sel, r_w, dict(rtol=1e-4, atol=1e-9))
    # XLA on the CPU flushes subnormal floats to zero and PyTorch does not:
    # where XLA has w = 0 the port may hold a subnormal w (an unnormalised
    # term far below any weight the filter keeps), picked at another slot
    live = r_w > 0
    assert live.any() and (~live).any()
    assert (w_sel.numpy()[~live] < 1.2e-38).all()
    # payload rows with w = 0 are don't-care: the merge skips them
    _close(mean.numpy().transpose(0, 2, 3, 1)[live],
           r_mean.transpose(0, 2, 3, 1)[live])
    _close(cov.numpy().transpose(0, 2, 3, 1)[live],
           r_cov.transpose(0, 2, 3, 1)[live])
    # by index: the same picks as (w, idx), idx 0 where w = 0, and the
    # port's gather at idx reproduces the payload
    b_sum, b_w, b_idx = TS4.fused_update_select4_by_index(_t(z), pre_t, tg,
                                                          k1=k1)
    assert b_idx.dtype == torch.int32
    assert torch.equal(b_sum, sum_exp) and torch.equal(b_w, w_sel)
    np.testing.assert_array_equal(b_idx.numpy()[live], r_f[live])
    assert not b_idx.numpy()[b_w.numpy() == 0].any()
    g_mean, g_cov = T4.gather_selected4(pre_t, tg, _t(z), b_idx)
    lv = torch.as_tensor(live)[:, None].expand_as(g_mean)
    torch.testing.assert_close(g_mean[lv], mean[lv], rtol=1e-6, atol=1e-6)
    lv = torch.as_tensor(live)[:, None].expand_as(g_cov)
    assert torch.equal(g_cov[lv], cov[lv])


# -------------------------------------------------------- merge4 kernel --

def _pool4(rng, P, K, zero_rows=(1,)):
    w = (rng.uniform(size=(P, K)) < 0.6) * rng.uniform(0.01, 2.0, (P, K))
    w[list(zero_rows)] = 0.0
    mean = np.concatenate([rng.uniform(-6, 6, (P, 2, K)),
                           rng.normal(0, 0.5, (P, 2, K))], 1)
    return (w.astype(np.float32), mean.astype(np.float32),
            _cov4(rng, (P, K), scale=0.5))


@pytest.mark.parametrize("P,K,cap,sep", [
    (16, 96, 7, 5.0),           # odd cap, reached before the pool empties
    (25, 80, 33, 1.0),          # odd P and cap, the shipped dynamic gate
    (16, 96, 48, 5.0),          # rows that run out of weight before cap
    (8, 60, 64, 1.0),           # cap above K
])
def test_plain_merge4_matches_xla(rng, P, K, cap, sep):
    """Weights and means at rtol 1e-5 / atol 1e-6 as in the 2-D merge test;
    covariances at 1e-4 / 1e-5 (one-pass centred against two-pass
    moments)."""
    w, mean, cov = _pool4(rng, P, K)
    ref = J4.greedy_merge4(jnp.asarray(w), jnp.asarray(mean),
                           jnp.asarray(cov), sep, cap, use_pallas=False)
    before = TM4.launches
    got = T4.greedy_merge4(_t(w), _t(mean), _t(cov), sep, cap)
    assert TM4.launches == before           # the CPU runs the plain version
    assert [tuple(g.shape) for g in got] == [(P, cap), (P, 4, cap),
                                             (P, 10, cap)]
    _close(got[0], ref[0], dict(rtol=1e-5, atol=1e-6), "w")
    _close(got[1], ref[1], dict(rtol=1e-4, atol=1e-5), "mean")
    _close(got[2], ref[2], dict(rtol=1e-4, atol=1e-5), "cov")
    # the all-zero row is an empty map: w 0, mean 0, identity covariance
    assert not got[0][1].any() and not got[1][1].any()
    np.testing.assert_array_equal(got[2][1].numpy(),
                                  np.asarray(ref[2][1]))
    assert set(np.unique(got[2][1].numpy())) == {0.0, 1.0}


# ---------------------------------------------------- phd_update_mixed --

def _mixed_scene(cfg, rng, P=8, F=16, M=8):
    """Both maps hold live slots in and out of the field of view; the
    measurements are near some dynamic features, near some static ones, or
    clutter; the last one is invalid."""
    g2 = _gm2(rng, P, F)
    g4 = _gm4(rng, P, F)
    pose = _pose(rng, P)
    z = _z(rng, M)
    # measurements 0-2 near dynamic features of particle 0, 3-4 static
    for m, f in ((0, 1), (1, 2), (2, 5)):
        g4["w"][:, f] = 0.8
        g4["mean_channels"][:, :2, f] = (
            pose[0, :2] + z[m, 0] * np.array([np.cos(pose[0, 2] + z[m, 1]),
                                              np.sin(pose[0, 2] + z[m, 1])])
            + rng.normal(0, 0.3, (P, 2)))
    for m, f in ((3, 0), (4, 3)):
        g2["w"][:, f] = 0.9
        xy = pose[0, :2] + z[m, 0] * np.array(
            [np.cos(pose[0, 2] + z[m, 1]), np.sin(pose[0, 2] + z[m, 1])])
        g2["mx"][:, f] = xy[0] + rng.normal(0, 0.3, P)
        g2["my"][:, f] = xy[1] + rng.normal(0, 0.3, P)
    g4["mean_channels"][:, :2, F - 1] = [-6.0, 0.0]     # behind: out of FOV
    g4["w"][:, F - 1] = 0.7
    valid = np.arange(M) < M - 1
    label = np.zeros(M, np.int32)
    label[[0, 1, 2, 6]] = 1
    return g2, g4, pose, z, label, valid


CASES = [dict(particleWeighting=pw, labeledMeasurements=bool(lab),
              keepOobDynamic=bool(oob))
         for pw in (0, 1) for lab in (0, 1) for oob in (0, 1)] + [
    dict(birthWeightDynamic=-1.0),
    dict(mergeMode=1, mergeMinWeight=1e-2),
    dict(birthVelocityInit=True)]


@pytest.mark.parametrize("sep", [1.0, 5.0, 0.37, 9.0, 123.456, 1e-20])
def test_merge4_first_pivot_exit_is_exact(sep):
    """csrc/merge4.cu's division-free exit, d0^2 > k0 max(a0, eps) in
    double, rejects a candidate only where the kernel's float32 first pivot
    already gives fl(y0 y0) >= min_sep (so its distance is >= min_sep too):
    pairs within 1e-6 of the boundary, a twentieth of them clamped."""
    f = np.float32
    rng = np.random.default_rng(int(sep * 1000) % 2**32)
    k0 = TM4.reject_scale(sep)
    n = 200_000
    a0 = (f(10.0) ** rng.uniform(-13, 3, n)).astype(f)
    a0 = np.where(rng.uniform(size=n) < 0.05, f(-1e-3), a0).astype(f)
    ap = np.maximum(a0, f(1e-12))
    d0 = (np.sqrt(sep * ap.astype(np.float64))
          * (1 + rng.normal(0, 1e-6, n))).astype(f)
    d0 = np.where(rng.uniform(size=n) < 0.5, -d0, d0)
    y0 = d0 / np.sqrt(ap)                   # IEEE float32, as the kernel
    reject = d0.astype(np.float64) ** 2 > k0 * ap.astype(np.float64)
    assert 0 < reject.sum() < n
    assert not (reject & ~(y0 * y0 >= f(sep))).any()


def test_merge4_first_pivot_exit_off_outside_its_range():
    for sep in (0.0, -1.0, float("nan"), 3.1e38, float("inf")):
        assert TM4.reject_scale(sep) == float("inf")


@pytest.mark.parametrize("over", CASES, ids=[
    "-".join(f"{k}={v}" for k, v in c.items()) for c in CASES])
def test_phd_update_mixed_matches_jax(mixed_cfg, over):
    cfg = mixed_cfg.replace(**over)
    rng = np.random.default_rng(7)
    g2, g4, pose, z, label, valid = _mixed_scene(cfg, rng)
    j2, t2 = _both2(g2)
    j4, t4 = _both4(g4)
    bv_j = bv_t = None
    if cfg.birthVelocityInit:
        zp = z + rng.normal(0, 0.1, z.shape).astype(np.float32)
        zp_valid = np.ones(len(z), bool)
        zw_j = J4.prev_measurement_world(jnp.asarray(pose), jnp.asarray(zp),
                                         jnp.asarray(zp_valid))
        bv_j = J4.informed_birth_velocity(
            jnp.asarray(pose), jnp.asarray(z), jnp.asarray(valid), zw_j,
            jnp.asarray(zp_valid), jnp.float32(1.0), cfg)
        zw_t = T4.prev_measurement_world(_t(pose), _t(zp),
                                         torch.as_tensor(zp_valid))
        bv_t = T4.informed_birth_velocity(
            _t(pose), _t(z), torch.as_tensor(valid), zw_t,
            torch.as_tensor(zp_valid), 1.0, cfg)
    ref = jax.jit(J4.phd_update_mixed, static_argnames=("cfg",))(
        jnp.asarray(pose), j2, j4, jnp.asarray(z), jnp.asarray(label),
        jnp.asarray(valid), cfg=cfg, birth_vel=bv_j)
    got = T4.phd_update_mixed(_t(pose), t2, t4, _t(z),
                              torch.as_tensor(label),
                              torch.as_tensor(valid), cfg, birth_vel=bv_t)
    for name in ("w", "mx", "my", "c00", "c01", "c11"):
        _close(getattr(got[0], name), getattr(ref[0], name), msg=name)
    for name in ("w", "mean_channels", "cov_channels"):
        _close(getattr(got[1], name), getattr(ref[1], name), msg=name)
    _close(got[2], ref[2], dict(rtol=2e-4, atol=1e-4), "log_weight_delta")
    assert float(got[1].w.sum()) > 0 and float(got[0].w.sum()) > 0

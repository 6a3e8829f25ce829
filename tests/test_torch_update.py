"""The port's measurement update against the JAX package's XLA branch.

JAX runs on the CPU, where ``phd_update_static`` takes its XLA route (the
[P, M, F] tensor, top_k and gathers); the port runs the select and merge
kernels' plain versions. Same numpy inputs through both, float32.

Tolerances follow tests/test_pallas.py, which holds the Pallas kernels to
the same XLA route: rtol 1e-4 / atol 1e-6 on sums, 2e-4 / 1e-6 on weighted
moments. The XLA route normalises in log space (exp(lw - log norm)), the
kernel as e / norm: that, the bearing wrap and the summation order account
for the last digits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.filter import update as JU
from phdslam_tpu.filter.state import Gaussian2DMixture as JG2
from phdslam_tpu.ops.linalg import safe_log as j_safe_log
from phdslam_tpu.ops.linalg import wrap_angle as j_wrap
from phdslam_tpu_torch.filter import update as TU
from phdslam_tpu_torch.filter.state import Gaussian2DMixture as TG2
from phdslam_tpu_torch.kernels import select as TS

torch.set_num_threads(1)


def _t(a, dtype=np.float32):
    return torch.as_tensor(np.array(a, dtype))


def _problem(tiny_cfg, rng, P=16, F=16, M=8):
    cfg = tiny_cfg.replace(n_particles=P, maxFeatures=F, maxMeasurements=M,
                           gateBirths=True, gateThreshold=9.0)
    w = ((rng.uniform(size=(P, F)) < 0.5)
         * rng.uniform(0.1, 1.0, (P, F))).astype(np.float32)
    mean = rng.uniform(-8, 8, (P, F, 2)).astype(np.float32)
    c00 = rng.uniform(0.1, 0.5, (P, F)).astype(np.float32)
    c11 = rng.uniform(0.1, 0.5, (P, F)).astype(np.float32)
    c01 = (0.3 * np.sqrt(c00 * c11)
           * rng.uniform(-1, 1, (P, F))).astype(np.float32)
    pose = rng.uniform(-1, 1, (P, 6)).astype(np.float32)
    z = np.stack([rng.uniform(0.5, 9.0, M), rng.uniform(-1.0, 1.0, M)],
                 1).astype(np.float32)
    chans = dict(w=w, mx=mean[..., 0], my=mean[..., 1], c00=c00, c01=c01,
                 c11=c11)
    return cfg, chans, pose, z


def _both(chans):
    return (JG2(**{k: jnp.asarray(v) for k, v in chans.items()}),
            TG2(**{k: _t(v) for k, v in chans.items()}))


def test_kalman_preupdate_matches_jax(tiny_cfg, rng):
    cfg, chans, pose, _ = _problem(tiny_cfg, rng)
    jg, tg = _both(chans)
    ref = JU.kalman_preupdate(jnp.asarray(pose), jg, cfg)
    got = TU.kalman_preupdate(_t(pose), tg, cfg)
    for name in ref._fields:
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        if name == "rclass":
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=2e-5, atol=2e-6,
                                       err_msg=name)


def _xla_selection(cfg, jg, pose, z_rb, z_valid, k1):
    """The XLA route's counterparts of the kernel outputs, built as
    tests/test_pallas.py::_xla_selection builds them."""
    pre = JU.kalman_preupdate(pose, jg, cfg)
    M = z_rb.shape[0]
    z_label = jnp.zeros((M,), jnp.int32)
    lw = JU.detection_log_weights(pre, jg, z_rb, z_label, z_valid, cfg)
    sum_exp = jnp.sum(jnp.exp(lw), axis=-1)
    g_single = lw - j_safe_log(pre.pd)[:, None, :] \
        - j_safe_log(jg.w)[:, None, :]
    dist = -2.0 * (g_single + 1.8378770664093453
                   + 0.5 * pre.log_det_s[:, None, :])
    compat = jnp.any((dist < cfg.gateThreshold)
                     & (pre.rclass == 1)[:, None, :], axis=-1)
    norm = sum_exp + cfg.clutterDensity + cfg.birthWeight
    w_det = jnp.exp(lw) / norm[..., None]
    w_det = jnp.where(w_det >= cfg.minFeatureWeight, w_det, 0.0)
    w_sel, f_sel = jax.lax.top_k(w_det, k1)
    P = pose.shape[0]
    take = lambda a: jnp.take_along_axis(
        a[:, None, :], jnp.broadcast_to(f_sel, (P, M, k1)), axis=2)
    ir = z_rb[None, :, None, 0] - take(pre.r)
    ib = j_wrap(z_rb[None, :, None, 1] - take(pre.bearing))
    mx = take(jg.mx) + take(pre.g00) * ir + take(pre.g01) * ib
    my = take(jg.my) + take(pre.g10) * ir + take(pre.g11) * ib
    return (sum_exp, compat, w_sel, mx, my, take(pre.u00), take(pre.u01),
            take(pre.u11))


@pytest.mark.parametrize("k1,n_valid", [(8, 8), (4, 8), (8, 5)])
def test_plain_select_matches_xla(tiny_cfg, rng, k1, n_valid):
    cfg, chans, pose, z = _problem(tiny_cfg, rng)
    jg, tg = _both(chans)
    M = z.shape[0]
    valid = np.arange(M) < n_valid
    ref = _xla_selection(cfg, jg, jnp.asarray(pose), jnp.asarray(z),
                         jnp.asarray(valid), k1)
    pre = TU.kalman_preupdate(_t(pose), tg, cfg)
    got = TS.fused_update_select(
        _t(z), pre, tg, cfg, k1=k1,
        n_valid=torch.tensor([n_valid], dtype=torch.int32))
    sum_exp, w_sel, mx, my, u00, u01, u11, lpw, compat = \
        [np.asarray(a) for a in got]
    r_sum, r_compat, r_w, r_mx, r_my, r_u00, r_u01, r_u11 = \
        [np.asarray(a) for a in ref]
    np.testing.assert_allclose(sum_exp, r_sum, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(compat, r_compat & valid[None, :])
    # columns at or past n_valid are zero
    assert not w_sel[:, n_valid:].any() and not sum_exp[:, n_valid:].any()
    # selected weights are a set per (p, m); sort to ignore tie order
    np.testing.assert_allclose(np.sort(w_sel, -1), np.sort(r_w, -1),
                               rtol=1e-4, atol=1e-7)
    for g, r in ((mx, r_mx), (my, r_my), (u00, r_u00), (u01, r_u01),
                 (u11, r_u11)):
        np.testing.assert_allclose((w_sel * g).sum(-1), (r_w * r).sum(-1),
                                   rtol=2e-4, atol=1e-6)
    assert not lpw.any()            # with_lpw follows particleWeighting 2


def test_plain_select_raw_mode(tiny_cfg, rng):
    """raw=True: unnormalized, unpruned exp(lw), same picks."""
    cfg, chans, pose, z = _problem(tiny_cfg, rng)
    jg, tg = _both(chans)
    pre_j = JU.kalman_preupdate(jnp.asarray(pose), jg, cfg)
    M = z.shape[0]
    lw = JU.detection_log_weights(pre_j, jg, jnp.asarray(z),
                                  jnp.zeros((M,), jnp.int32),
                                  jnp.ones((M,), bool), cfg)
    ref, _ = jax.lax.top_k(jnp.exp(lw), 8)
    pre = TU.kalman_preupdate(_t(pose), tg, cfg)
    got = TS.fused_update_select(_t(z), pre, tg, cfg, k1=8, raw=True)
    np.testing.assert_allclose(np.sort(got[1].numpy(), -1),
                               np.sort(np.asarray(ref), -1),
                               rtol=1e-4, atol=1e-12)


def test_xla_route_functions_match_jax(tiny_cfg, rng):
    """detection_log_weights ([P, M, F], -inf where a pair takes no part)
    and gather_selected (payload of given feature indices), the XLA route
    the port keeps for the index-mode selection."""
    cfg, chans, pose, z = _problem(tiny_cfg, rng)
    jg, tg = _both(chans)
    M = z.shape[0]
    valid = np.arange(M) < 6
    pre_j = JU.kalman_preupdate(jnp.asarray(pose), jg, cfg)
    pre_t = TU.kalman_preupdate(_t(pose), tg, cfg)
    ref = np.asarray(JU.detection_log_weights(
        pre_j, jg, jnp.asarray(z), jnp.zeros((M,), jnp.int32),
        jnp.asarray(valid), cfg))
    got = TU.detection_log_weights(pre_t, tg, _t(z),
                                   torch.zeros(M, dtype=torch.int32),
                                   torch.as_tensor(valid), cfg).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    assert fin.any()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-4)
    _, f_sel = jax.lax.top_k(jnp.asarray(ref), 4)
    r_pay = JU.gather_selected(pre_j, jg, jnp.asarray(z), f_sel)
    g_pay = TU.gather_selected(pre_t, tg, _t(z),
                               torch.as_tensor(np.array(f_sel)))
    for g, r in zip(g_pay, r_pay):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=2e-5)


def _setup(cfg):
    """tests/test_update_parity.py's hand-built scene: two particles, five
    features (one out of range), six measurements incl. a negative range."""
    P, F, M = 2, cfg.maxFeatures, cfg.maxMeasurements
    pose = np.array([[0, 0, 0, 0, 0, 0], [0.5, -0.3, 0.1, 0, 0, 0]],
                    np.float32)
    w = np.zeros((P, F), np.float32)
    mean = np.zeros((P, F, 2), np.float32)
    feats = np.array([[3, 1], [5, -2], [2, 4], [11, 1], [20, 5]],
                     np.float32)
    weights = [0.9, 0.5, 1.2, 0.8, 0.6]
    for p in range(P):
        for i, f in enumerate(feats):
            w[p, i] = weights[i]
            mean[p, i] = f + p * 0.1
    z = np.array([[3.1, 0.32], [5.5, -0.37], [7.0, 1.2], [2.2, -0.8],
                  [4.4, 1.05], [-1.0, 0.5]], np.float32)
    z_rb = np.zeros((M, 2), np.float32)
    z_rb[:6] = z
    z_valid = np.zeros(M, bool)
    z_valid[:6] = True
    chans = dict(w=w, mx=mean[..., 0], my=mean[..., 1],
                 c00=np.full((P, F), 0.3, np.float32),
                 c01=np.zeros((P, F), np.float32),
                 c11=np.full((P, F), 0.3, np.float32))
    return pose, chans, z_rb, z_valid


@pytest.mark.parametrize("gate", [0, 1])
@pytest.mark.parametrize("weighting", [0, 1, 2])
def test_phd_update_static_matches_jax(tiny_cfg, weighting, gate):
    cfg = tiny_cfg.replace(particleWeighting=weighting,
                           gateBirths=bool(gate), gateThreshold=9.0)
    got = _check_update(cfg)
    if gate:
        # the scene has measurements explained by features: some gated
        assert (got.w_birth.numpy() == 0)[:, :6].any()


def test_phd_update_static_fast_merge_matches_jax(tiny_cfg):
    """merge_mode 1: top-4 detection terms, pre-merge prune at
    merge_min_weight with mass renormalization."""
    _check_update(tiny_cfg.replace(mergeMode=1, mergeMinWeight=1e-2))


def _check_update(cfg):
    pose, chans, z_rb, z_valid = _setup(cfg)
    jg, tg = _both(chans)
    M = z_rb.shape[0]
    ref = jax.jit(JU.phd_update_static, static_argnames=("cfg",))(
        jnp.asarray(pose), jg, jnp.asarray(z_rb),
        jnp.zeros((M,), jnp.int32), jnp.asarray(z_valid), cfg=cfg)
    got = TU.phd_update_static(_t(pose), tg, _t(z_rb),
                               torch.zeros(M, dtype=torch.int32),
                               torch.as_tensor(z_valid), cfg)
    # the merged map: same greedy picks, same slots
    for name in ("w", "mx", "my", "c00", "c01", "c11"):
        np.testing.assert_allclose(getattr(got.map_out, name).numpy(),
                                   np.asarray(getattr(ref.map_out, name)),
                                   rtol=2e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got.log_weight_delta.numpy(),
                               np.asarray(ref.log_weight_delta),
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(got.w_birth.numpy(), np.asarray(ref.w_birth),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got.det_mass.numpy(),
                               np.asarray(ref.det_mass), rtol=1e-4,
                               atol=1e-6)
    return got


def test_phd_variance_matches_jax(tiny_cfg):
    cfg = tiny_cfg
    pose, chans, z_rb, z_valid = _setup(cfg)
    jg, tg = _both(chans)
    M = z_rb.shape[0]
    ref = jax.jit(JU.phd_update_static, static_argnames=("cfg",))(
        jnp.asarray(pose), jg, jnp.asarray(z_rb),
        jnp.zeros((M,), jnp.int32), jnp.asarray(z_valid), cfg=cfg)
    got = TU.phd_update_static(_t(pose), tg, _t(z_rb),
                               torch.zeros(M, dtype=torch.int32),
                               torch.as_tensor(z_valid), cfg)
    np.testing.assert_allclose(
        TU.phd_variance(got, torch.as_tensor(z_valid)).numpy(),
        np.asarray(JU.phd_variance(ref, jnp.asarray(z_valid))),
        rtol=1e-4, atol=1e-6)

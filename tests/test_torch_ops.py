"""Element-wise parity of the port's small math against the JAX package:
the same numpy inputs through both, float32 on the CPU.

Tolerances: 1e-6 relative / 1e-6 absolute where the two run the same
float32 formula (libm and XLA may differ by an ulp in sin, cos, atan2,
tan, exp); exact for integer outputs and for the resample indices."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.filter import predict as JP
from phdslam_tpu.models import measurement as JMe
from phdslam_tpu.models import motion as JMo
from phdslam_tpu.ops import linalg as JL
from phdslam_tpu.ops import resample as JR
from phdslam_tpu_torch.filter import predict as TP
from phdslam_tpu_torch.kernels import select as TS
from phdslam_tpu_torch.models import measurement as TMe
from phdslam_tpu_torch.models import motion as TMo
from phdslam_tpu_torch.ops import linalg as TL
from phdslam_tpu_torch.ops import resample as TR

torch.set_num_threads(1)

RT = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               **(tol or RT))


def test_safe_log_floor_and_values():
    # normal floats only: XLA on the CPU flushes subnormals to zero
    x = np.array([2.5, 1e-30, 0.0, -1.0, 2e-38, 7.0e5], np.float32)
    got = TL.safe_log(_t(x)).numpy()
    ref = np.asarray(JL.safe_log(jnp.asarray(x)))
    _close(got, ref, rtol=1e-6, atol=0)
    # the floor is -FLT_MAX, exactly
    assert got[2] == got[3] == np.float32(-3.4028235e38)


def test_wrap_angle_matches_fmod_fold(rng):
    a = np.concatenate([rng.uniform(-20, 20, 200),
                        [np.pi, -np.pi, 3 * np.pi, 2 * np.pi, 0.0]])
    a = a.astype(np.float32)
    # same float32 fmod and fold: bit-identical
    np.testing.assert_array_equal(TL.wrap_angle(_t(a)).numpy(),
                                  np.asarray(JL.wrap_angle(jnp.asarray(a))))


def test_logistic(rng):
    x = rng.uniform(-6, 6, 50).astype(np.float32)
    _close(TL.logistic(_t(x), 0.0, 0.98, 2.0, 0.5),
           JL.logistic(jnp.asarray(x), 0.0, 0.98, 2.0, 0.5))


def _ulps_around(c, n=8):
    x = np.float32(c)
    for _ in range(n):
        x = np.nextafter(x, np.float32(-np.inf))
    out = []
    for _ in range(2 * n + 1):
        out.append(x)
        x = np.nextafter(x, np.float32(np.inf))
    return np.array(out, np.float32)


def test_bearing_wrap_boundary_select_uses_round():
    """The select kernel wraps the bearing innovation with
    x - 2pi round(x / 2pi) (the Pallas kernel's rule, half to even), the
    XLA path with fmod-then-fold. Pin the port's choice at the boundary:
    within 8 ulps of +-pi and +-2pi, the innovations two bearings in
    [-pi, pi] can make, the rules agree bit for bit in float32; at 3pi,
    which only a bearing outside [-pi, pi] reaches, round lands on -pi
    and fold on +pi, and the select follows round."""
    pi = np.pi
    near = np.concatenate([_ulps_around(c) for c in (pi, -pi, 2 * pi,
                                                      -2 * pi)])
    np.testing.assert_array_equal(TS._wrap_round(_t(near)).numpy(),
                                  TL.wrap_angle(_t(near)).numpy())
    x = np.array([3 * pi, -3 * pi], np.float32)
    rnd = TS._wrap_round(_t(x)).numpy()
    fold = TL.wrap_angle(_t(x)).numpy()
    assert rnd[0] < 0 < fold[0] and rnd[1] > 0 > fold[1]
    np.testing.assert_allclose(np.abs(rnd), pi, rtol=1e-6)
    # the same arithmetic as the Pallas body: ib - 2pi * jnp.round(ib / 2pi)
    two_pi = np.float32(2.0 * math.pi)
    allx = np.concatenate([near, x])
    ref = allx - two_pi * np.round(allx / two_pi)
    np.testing.assert_array_equal(TS._wrap_round(_t(allx)).numpy(),
                                  ref.astype(np.float32))


def test_measurement_model(tiny_cfg, rng):
    pose = rng.uniform(-2, 2, (16, 6)).astype(np.float32)
    feat = rng.uniform(-12, 12, (16, 5, 2)).astype(np.float32)
    got = TMe.predict_measurement(_t(pose)[:, None, :], _t(feat))
    ref = JMe.predict_measurement(jnp.asarray(pose)[:, None, :],
                                  jnp.asarray(feat))
    for g, r in zip(got, ref):
        _close(g, r, rtol=1e-5, atol=2e-6)
    r, b = got[0], got[1]
    cfg = tiny_cfg.replace(minRange=1.0)
    np.testing.assert_array_equal(
        TMe.range_class(r, b, cfg).numpy(),
        np.asarray(JMe.range_class(jnp.asarray(r.numpy()),
                                   jnp.asarray(b.numpy()), cfg)))


def test_birth_gaussian(tiny_cfg, rng):
    pose = rng.uniform(-2, 2, (6, 6)).astype(np.float32)
    z = np.stack([rng.uniform(-1, 10, 6), rng.uniform(-1.5, 1.5, 6)],
                 -1).astype(np.float32)
    gm, gc = TMe.birth_gaussian(_t(pose), _t(z), tiny_cfg)
    rm, rc = JMe.birth_gaussian(jnp.asarray(pose), jnp.asarray(z), tiny_cfg)
    _close(gm, rm, rtol=1e-6, atol=1e-5)
    _close(gc, rc, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("motion", ["ackerman", "cv"])
def test_motion_models(tiny_cfg, rng, motion):
    pose = rng.uniform(-3, 3, (32, 6)).astype(np.float32)
    dt = np.float32(0.7)
    if motion == "ackerman":
        noise = rng.normal(0, 0.1, (32, 2)).astype(np.float32)
        ctrl = (np.float32(1.3), np.float32(0.2))
        got = TMo.ackerman_predict(_t(pose), (float(ctrl[0]),
                                              float(ctrl[1])),
                                   _t(noise), tiny_cfg, float(dt))
        ref = JMo.ackerman_predict(jnp.asarray(pose), ctrl,
                                   jnp.asarray(noise), tiny_cfg, dt)
    else:
        noise = rng.normal(0, 0.5, (32, 3)).astype(np.float32)
        got = TMo.cv_predict(_t(pose), _t(noise), float(dt))
        ref = JMo.cv_predict(jnp.asarray(pose), jnp.asarray(noise), dt)
    _close(got, ref, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("motion_type", [0, 1])
def test_predict_pose_noise_scales(tiny_cfg, rng, motion_type):
    """predict_pose scales standard normals by motion type (CV: 3x the
    acceleration sigmas; Ackerman: stdEncoder, stdAlpha) exactly as
    phdslam_tpu.filter.predict does with the same key's draws."""
    cfg = tiny_cfg.replace(motionType=motion_type, ax=0.4, ay=0.1,
                           ayaw=0.02, stdEncoder=0.3, stdAlpha=0.02)
    pose = rng.uniform(-3, 3, (16, 6)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    d = 2 if motion_type == 1 else 3
    normals = np.asarray(jax.random.normal(key, (16, d), jnp.float32))
    ctrl = (np.float32(1.1), np.float32(-0.1))
    ref = JP.predict_pose(key, jnp.asarray(pose), ctrl, cfg,
                          np.float32(1.0))
    got = TP.predict_pose(_t(pose), (float(ctrl[0]), float(ctrl[1])),
                          _t(normals), cfg, 1.0)
    _close(got, ref, rtol=1e-5, atol=2e-6)


def test_stratified_resample_and_neff(rng):
    lw = rng.normal(0, 2, 64).astype(np.float32)
    lw = lw - np.logaddexp.reduce(lw.astype(np.float64)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (64,), jnp.float32))
    ref = JR.stratified_resample_indices(key, jnp.asarray(lw), 64)
    got = TR.stratified_resample_indices(_t(lw), _t(u), 64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    _close(TR.neff(_t(lw)), JR.neff(jnp.asarray(lw)), rtol=1e-5, atol=0)


@pytest.mark.parametrize("n_runs", [None, 3])
def test_stratified_resample_never_scans_one_row(rng, monkeypatch, n_runs):
    """F9: the cumulative weights are never a one-row scan, the only kind
    torch's CUDA cumsum does not repeat bit for bit (CUB's device scan:
    from 32,768 weights on an H100 two calls can differ, and BASELINE
    config 5's 65,536 particles resampled otherwise run to run). One run
    is scanned as the first of two rows, R runs as they are; the indices
    are the same as each run's alone."""
    R = n_runs or 1
    lw = np.log(rng.dirichlet(np.ones(64), size=R)).astype(np.float32)
    u = rng.uniform(size=(R, 64)).astype(np.float32)
    rows = []
    cumsum = torch.cumsum

    def recording(x, dim, *a, **kw):
        rows.append(x.shape[0] if x.dim() > 1 else 1)
        return cumsum(x, dim, *a, **kw)

    monkeypatch.setattr(torch, "cumsum", recording)
    got = TR.stratified_resample_indices(_t(lw.reshape(-1)),
                                         _t(u.reshape(-1)), 64, n_runs)
    monkeypatch.undo()
    assert rows and min(rows) >= 2, rows
    for r in range(R):
        alone = TR.stratified_resample_indices(_t(lw[r]), _t(u[r]), 64)
        np.testing.assert_array_equal(got.numpy()[r * 64:(r + 1) * 64],
                                      alone.numpy() + r * 64)


def test_resample_overrun_guard():
    """Weights summing below 1: positions past the cumulative sum take the
    maximum-weight particle, as in the JAX guard."""
    lw = np.log(np.array([0.1, 0.5, 0.2, 0.1], np.float32))   # sums to 0.9
    u = np.array([0.5, 0.5, 0.5, 0.99], np.float32)
    got = TR.stratified_resample_indices(_t(lw), _t(u), 4).numpy()
    assert got[-1] == 1
    np.testing.assert_array_equal(got, [1, 1, 2, 1])

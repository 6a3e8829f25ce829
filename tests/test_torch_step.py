"""The port's SLAM step against ``phdslam_tpu.filter.step.slam_step`` on the
tiny config, with JAX's random draws replayed into the port.

JAX derives one step's draws as k_pred, k_var, k_res = split(key, 3);
keys = split(k_pred, sub); normal(keys[i], (P, 2)); uniform(k_res, (P,)).
The test makes them with jax.random on the CPU and hands them to the port
as ``noise``. Tolerances: rtol 1e-4 / atol 1e-5 on poses, weights and maps
(float32 through predict, the update's normalisers and the merge moments,
compounded over three steps); resample indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.filter import step as JS
from phdslam_tpu.filter.state import Gaussian2DMixture as JG2
from phdslam_tpu.filter.state import Gaussian4DMixture as JG4
from phdslam_tpu.filter.state import Measurements as JMeas
from phdslam_tpu.filter.state import SlamState as JState
from phdslam_tpu.simdata import generate_run, make_scenario
from phdslam_tpu_torch.bridge import state_from_numpy, state_to_numpy
from phdslam_tpu_torch.filter import step as TS
from phdslam_tpu_torch.filter.predict import noise_dim
from phdslam_tpu_torch.filter.state import Measurements as TMeas

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def run():
    sc = make_scenario(np.random.default_rng(11), n_landmarks=12,
                       n_steps=6, clutter_rate=2.0)
    controls, meas = generate_run(np.random.default_rng(12), sc,
                                  control_noise=(0.05, 0.005))
    return controls, meas


def _z(meas_t, M):
    rb = np.zeros((M, 2), np.float32)
    valid = np.zeros((M,), bool)
    k = min(len(meas_t), M)
    rb[:k] = meas_t[:k]
    valid[:k] = True
    lab = np.zeros((M,), np.int32)
    return (JMeas(rb=jnp.asarray(rb), label=jnp.asarray(lab),
                  valid=jnp.asarray(valid)),
            TMeas.from_numpy(rb, lab, valid))


def _draws(key, cfg, n_pred):
    """JAX's draws for slam_step(key): (normals [sub, P, d], uniforms), d
    = 2 for Ackerman motion and 3 for CV motion."""
    k_pred, _k_var, k_res = jax.random.split(key, 3)
    sub = max(int(cfg.subdividePredict), 1)
    keys = jax.random.split(k_pred, sub)
    d = noise_dim(cfg)
    normals = np.stack([np.asarray(jax.random.normal(keys[i], (n_pred, d),
                                                     jnp.float32))
                        for i in range(sub)])
    u = np.asarray(jax.random.uniform(k_res, (cfg.n_particles,),
                                      jnp.float32))
    return torch.as_tensor(normals), torch.as_tensor(np.array(u))


def _to_jax(d):
    return JState(
        pose=jnp.asarray(d["pose"]), log_weights=jnp.asarray(
            d["log_weights"]),
        map_static=JG2(**{k: jnp.asarray(v)
                          for k, v in d["map_static"].items()}),
        map_dynamic=JG4(**{k: jnp.asarray(v)
                           for k, v in d["map_dynamic"].items()}),
        resample_idx=jnp.asarray(d["resample_idx"]),
        variances=jnp.asarray(d["variances"]))


def _compare(tstate, jstate, tag):
    j = jax.device_get(jstate)
    np.testing.assert_allclose(tstate.pose.numpy(), j.pose, err_msg=tag,
                               **TOL)
    np.testing.assert_allclose(tstate.log_weights.numpy(), j.log_weights,
                               err_msg=tag, **TOL)
    np.testing.assert_array_equal(tstate.resample_idx.numpy(),
                                  j.resample_idx, err_msg=tag)
    for name in ("w", "mx", "my", "c00", "c01", "c11"):
        np.testing.assert_allclose(
            getattr(tstate.map_static, name).numpy(),
            getattr(j.map_static, name), err_msg=f"{tag} {name}", rtol=2e-4,
            atol=1e-4)


def _step_both(jstate, tstate, key, ctrl, zj, zt, t, cfg):
    jnew, jaux = JS.slam_step(jstate, key, (jnp.float32(ctrl[0]),
                                            jnp.float32(ctrl[1])), zj,
                              jnp.float32(cfg.dt), jnp.asarray(t > 0), cfg)
    tnew, taux = TS.slam_step(
        tstate, (float(ctrl[0]), float(ctrl[1])), zt, float(cfg.dt), t > 0,
        cfg, noise=_draws(key, cfg, tstate.n_particles))
    return jnew, jaux, tnew, taux


def test_three_steps_match_jax(tiny_cfg, run):
    controls, meas = run
    cfg = tiny_cfg.replace(birthWeight=0.02)
    jstate = JState.create(cfg)
    tstate = state_from_numpy(jax.device_get(jstate))
    key = jax.random.PRNGKey(5)
    for t in range(3):
        key, sk = jax.random.split(key)
        ctrl = controls[t - 1] if t > 0 else np.zeros(2, np.float32)
        zj, zt = _z(meas[t], cfg.maxMeasurements)
        jstate, jaux, tstate, taux = _step_both(jstate, tstate, sk, ctrl,
                                                zj, zt, t, cfg)
        _compare(tstate, jstate, f"step {t}")
        for name in ("expected_pose", "neff", "log_lik"):
            np.testing.assert_allclose(
                getattr(taux, name).numpy(),
                np.asarray(getattr(jaux, name)), err_msg=name, **TOL)
        assert bool(taux.resampled) == bool(jaux.resampled)
        assert int(taux.n_measure) == int(jaux.n_measure)
    assert tstate.map_static.w.sum() > 0


@pytest.mark.parametrize("modes", [
    dict(selectTopK=2),
    dict(mergeMode=1, selectTopK=2, mergeMinWeight=1e-2)],
    ids=["k2", "fast_merge_k2"])
def test_three_steps_fast_modes_match_jax(tiny_cfg, run, modes):
    """The benchmark's fast modes through three whole steps: two detection
    candidates a measurement (select's k1 = 2), alone and under merge_mode
    1 (fast_prune_renormalize before the merge), at the Ackerman test's
    tolerances (rtol 1e-4 / atol 1e-5 on poses, weights and the aux
    values, rtol 2e-4 / atol 1e-4 on the maps, resample indices
    exactly)."""
    controls, meas = run
    cfg = tiny_cfg.replace(birthWeight=0.02, **modes)
    jstate = JState.create(cfg)
    tstate = state_from_numpy(jax.device_get(jstate))
    key = jax.random.PRNGKey(17)
    for t in range(3):
        key, sk = jax.random.split(key)
        ctrl = controls[t - 1] if t > 0 else np.zeros(2, np.float32)
        zj, zt = _z(meas[t], cfg.maxMeasurements)
        jstate, jaux, tstate, taux = _step_both(jstate, tstate, sk, ctrl,
                                                zj, zt, t, cfg)
        _compare(tstate, jstate, f"step {t}")
        for name in ("expected_pose", "neff", "log_lik"):
            np.testing.assert_allclose(
                getattr(taux, name).numpy(),
                np.asarray(getattr(jaux, name)), err_msg=name, **TOL)
    assert tstate.map_static.w.sum() > 0


def test_three_cv_motion_steps_match_jax(tiny_cfg, run):
    """motionType 0 (constant-velocity pose noise, three times the
    configured acceleration sigmas, [P, 3] draws) through three whole
    steps, at the Ackerman test's tolerances (rtol 1e-4 / atol 1e-5 on
    poses, weights and the aux values, rtol 2e-4 / atol 1e-4 on the maps,
    resample indices exactly)."""
    controls, meas = run
    cfg = tiny_cfg.replace(birthWeight=0.02, motionType=0)
    jstate = JState.create(cfg)
    tstate = state_from_numpy(jax.device_get(jstate))
    key = jax.random.PRNGKey(7)
    for t in range(3):
        key, sk = jax.random.split(key)
        ctrl = controls[t - 1] if t > 0 else np.zeros(2, np.float32)
        zj, zt = _z(meas[t], cfg.maxMeasurements)
        pose0 = tstate.pose.clone()
        jstate, jaux, tstate, taux = _step_both(jstate, tstate, sk, ctrl,
                                                zj, zt, t, cfg)
        _compare(tstate, jstate, f"CV step {t}")
        for name in ("expected_pose", "neff", "log_lik"):
            np.testing.assert_allclose(
                getattr(taux, name).numpy(),
                np.asarray(getattr(jaux, name)), err_msg=name, **TOL)
        assert bool(taux.resampled) == bool(jaux.resampled)
        if t > 0:                       # the CV noise moved the particles
            assert not torch.equal(tstate.pose, pose0)
    assert tstate.map_static.w.sum() > 0


def test_resampling_step_matches_jax(tiny_cfg, run):
    """resampleThresh 1.0 makes every update step resample (nEff <= 1):
    the indices, the gathered particles and the uniform weights match."""
    controls, meas = run
    cfg = tiny_cfg.replace(birthWeight=0.02, resampleThresh=1.0)
    jstate = JState.create(cfg)
    tstate = state_from_numpy(jax.device_get(jstate))
    key = jax.random.PRNGKey(9)
    for t in range(2):
        key, sk = jax.random.split(key)
        ctrl = controls[t - 1] if t > 0 else np.zeros(2, np.float32)
        zj, zt = _z(meas[t], cfg.maxMeasurements)
        jstate, jaux, tstate, taux = _step_both(jstate, tstate, sk, ctrl,
                                                zj, zt, t, cfg)
        assert bool(jaux.resampled) and bool(taux.resampled)
        _compare(tstate, jstate, f"step {t}")
    n = cfg.n_particles
    np.testing.assert_allclose(tstate.log_weights.numpy(), -np.log(n),
                               rtol=1e-6)


def test_shotgun_and_substeps_match_jax(tiny_cfg, run):
    """nPredictParticles = 2 (shotgun: every particle predicted twice, then
    always contracted back by resampling) and subdividePredict = 2 (two
    pose sub-steps with their own draws)."""
    controls, meas = run
    cfg = tiny_cfg.replace(birthWeight=0.02, nPredictParticles=2,
                           subdividePredict=2)
    jstate = JState.create(cfg)
    tstate = state_from_numpy(jax.device_get(jstate))
    key = jax.random.PRNGKey(13)
    for t in range(2):
        key, sk = jax.random.split(key)
        ctrl = controls[t - 1] if t > 0 else np.zeros(2, np.float32)
        zj, zt = _z(meas[t], cfg.maxMeasurements)
        jnew, jaux = JS.slam_step(
            jstate, sk, (jnp.float32(ctrl[0]), jnp.float32(ctrl[1])), zj,
            jnp.float32(cfg.dt), jnp.asarray(t > 0), cfg)
        tstate, taux = TS.slam_step(
            tstate, (float(ctrl[0]), float(ctrl[1])), zt, float(cfg.dt),
            t > 0, cfg, noise=_draws(sk, cfg, 2 * cfg.n_particles))
        jstate = jnew
        assert tstate.n_particles == cfg.n_particles
        assert bool(taux.resampled) and bool(jaux.resampled)
        _compare(tstate, jstate, f"step {t}")


def test_no_measurement_step_keeps_map_and_weights(tiny_cfg, run):
    """An odometry-only step moves the particles but leaves the map mass,
    the weights and the lineage untouched, and does not resample."""
    controls, meas = run
    cfg = tiny_cfg
    tstate = state_from_numpy(jax.device_get(JState.create(cfg)))
    g = torch.Generator().manual_seed(0)
    _, z0 = _z(np.array([[3.0, 0.1]], np.float32), cfg.maxMeasurements)
    tstate, _ = TS.slam_step(tstate, (0.0, 0.0), z0, 1.0, False, cfg,
                             generator=g)
    mass0 = float(tstate.map_static.w.sum())
    lw0 = tstate.log_weights.clone()
    empty = TMeas.empty(cfg.maxMeasurements)
    moved, aux = TS.slam_step(tstate, (1.0, 0.0), empty, 1.0, True, cfg,
                              generator=g)
    assert abs(float(moved.map_static.w.sum()) - mass0) < 1e-6
    torch.testing.assert_close(moved.log_weights, lw0, rtol=0, atol=0)
    assert not bool(aux.resampled)
    assert float(aux.log_lik) == 0.0 and int(aux.n_measure) == 0
    np.testing.assert_array_equal(moved.resample_idx.numpy(),
                                  np.arange(cfg.n_particles))
    assert not torch.equal(moved.pose, tstate.pose)


def test_bridge_round_trip(tiny_cfg, run):
    """JAX state -> numpy -> port -> numpy -> JAX keeps every field, the
    empty static-path dynamic map and the CPHD-only None fields included."""
    controls, meas = run
    cfg = tiny_cfg.replace(birthWeight=0.02)
    key = jax.random.PRNGKey(1)
    zj, _ = _z(meas[0], cfg.maxMeasurements)
    jstate, _ = JS.slam_step(JState.create(cfg), key,
                             (jnp.float32(0), jnp.float32(0)), zj,
                             jnp.float32(1.0), jnp.asarray(False), cfg)
    host = jax.device_get(jstate)
    tstate = state_from_numpy(host)
    assert tstate.map_dynamic.w.shape == (cfg.n_particles, 0)
    assert tstate.cardinality is None and tstate.cn_birth is None
    assert tstate.resample_idx.dtype == torch.int32
    back = _to_jax(state_to_numpy(tstate))
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax.tree.structure(host) == jax.tree.structure(back)

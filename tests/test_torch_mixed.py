"""The port's mixed static + dynamic SLAM step against
``phdslam_tpu.filter.step`` (JAX's draws replayed into the port, as in
tests/test_torch_step.py), the by-index selection modes against the payload
modes, the mixed state and its bridge, a mixed ``run_scan`` that must
confirm a crossing mover, and the runner's dynamic-map log line.

Tolerances: rtol 1e-4 / atol 1e-5 on poses and weights, rtol 2e-4 /
atol 1e-4 on the maps (float32 through predict, the joint normalisers and
two merges, compounded over three steps); resample indices exactly.
"""

import json
import os

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
from phdslam_tpu_torch import runner, simdata
from phdslam_tpu_torch.bridge import state_from_numpy, state_to_numpy
from phdslam_tpu_torch.config import load_config
from phdslam_tpu_torch.filter import step as TS
from phdslam_tpu_torch.filter import update as TU
from phdslam_tpu_torch.filter.state import Measurements as TMeas
from phdslam_tpu_torch.filter.state import SlamState as TState
from phdslam_tpu_torch.io.logs import read_state_estimate_log

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
MAP_TOL = dict(rtol=2e-4, atol=1e-4)


@pytest.fixture(scope="module")
def mixed_cfg():
    from phdslam_tpu.config import load_config as j_load
    return j_load("cfg/mixed_synth.cfg").replace(
        n_particles=8, maxFeatures=16, maxMeasurements=8, y0=0.0,
        clutterRate=2.0, stdEncoder=0.05, stdAlpha=0.005)


@pytest.fixture(scope="module")
def run():
    """A mover crossing a small landmark field: (controls, measurements)."""
    sc = simdata.make_scenario(np.random.default_rng(11), n_landmarks=12,
                               n_steps=6, clutter_rate=2.0)
    controls, meas, _ = simdata.generate_mixed_run(
        np.random.default_rng(12), sc, np.array([[4.0, -2.0]]),
        np.array([[0.0, 0.3]]), control_noise=(0.05, 0.005))
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
    """JAX's draws for slam_step(key): (normals [sub, P, 2], uniforms)."""
    k_pred, _k_var, k_res = jax.random.split(key, 3)
    sub = max(int(cfg.subdividePredict), 1)
    keys = jax.random.split(k_pred, sub)
    normals = np.stack([np.asarray(jax.random.normal(keys[i], (n_pred, 2),
                                                     jnp.float32))
                        for i in range(sub)])
    u = np.asarray(jax.random.uniform(k_res, (cfg.n_particles,),
                                      jnp.float32))
    return torch.as_tensor(normals), torch.as_tensor(np.array(u))


def _to_jax(d):
    return JState(
        pose=jnp.asarray(d["pose"]),
        log_weights=jnp.asarray(d["log_weights"]),
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
            getattr(j.map_static, name), err_msg=f"{tag} {name}", **MAP_TOL)
    for name in ("w", "mean_channels", "cov_channels"):
        np.testing.assert_allclose(
            getattr(tstate.map_dynamic, name).numpy(),
            getattr(j.map_dynamic, name), err_msg=f"{tag} {name}",
            **MAP_TOL)


@pytest.mark.parametrize("over", [
    dict(featureModel=2), dict(featureModel=1),
    dict(featureModel=2, birthVelocityInit=True, nPredictParticles=2)],
    ids=["mixed", "dynamic", "mixed-informed-shotgun"])
def test_three_mixed_steps_match_jax(mixed_cfg, run, over):
    controls, meas = run
    cfg = mixed_cfg.replace(**over)
    jstate = JState.create(cfg)
    tstate = state_from_numpy(jax.device_get(jstate))
    key = jax.random.PRNGKey(5)
    zj_prev = zt_prev = None
    n_pred = cfg.n_particles * max(cfg.nPredictParticles, 1)
    for t in range(3):
        key, sk = jax.random.split(key)
        ctrl = controls[t - 1] if t > 0 else np.zeros(2, np.float32)
        zj, zt = _z(meas[t], cfg.maxMeasurements)
        jstate, jaux = JS.slam_step(
            jstate, sk, (jnp.float32(ctrl[0]), jnp.float32(ctrl[1])), zj,
            jnp.float32(cfg.dt), jnp.asarray(t > 0), cfg, z_prev=zj_prev)
        tstate, taux = TS.slam_step(
            tstate, (float(ctrl[0]), float(ctrl[1])), zt, float(cfg.dt),
            t > 0, cfg, noise=_draws(sk, cfg, n_pred), z_prev=zt_prev)
        zj_prev, zt_prev = zj, zt
        _compare(tstate, jstate, f"step {t}")
        for name in ("expected_pose", "neff", "log_lik"):
            np.testing.assert_allclose(
                getattr(taux, name).numpy(), np.asarray(getattr(jaux, name)),
                err_msg=name, **TOL)
        assert bool(taux.resampled) == bool(jaux.resampled)
    assert float(tstate.map_dynamic.w.sum()) > 0
    assert float(tstate.map_static.w.sum()) > 0


def test_mixed_state_log_aux_and_bridge(mixed_cfg, run):
    """SlamState.create at feature_model 2 (Fd = maxFeatures), log_aux's
    dynamic rows against JAX's _log_aux, and a JAX mixed state through the
    bridge and back, every field kept."""
    _, meas = run
    cfg = mixed_cfg
    jstate = JState.create(cfg)
    tnew = TState.create(cfg)
    host = jax.device_get(jstate)
    assert tnew.map_dynamic.w.shape == (cfg.n_particles, cfg.maxFeatures)
    for a, b in zip(jax.tree.leaves(host),
                    jax.tree.leaves(_to_jax(state_to_numpy(tnew)))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    zj, _ = _z(meas[0], cfg.maxMeasurements)
    jstate, _ = JS.slam_step(jstate, jax.random.PRNGKey(1),
                             (jnp.float32(0), jnp.float32(0)), zj,
                             jnp.float32(1.0), jnp.asarray(False), cfg)
    host = jax.device_get(jstate)
    assert host.map_dynamic.w.sum() > 0
    tstate = state_from_numpy(host)
    assert tstate.map_dynamic.cov_channels.shape == (cfg.n_particles, 10,
                                                     cfg.maxFeatures)
    back = _to_jax(state_to_numpy(tstate))
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax.tree.structure(host) == jax.tree.structure(back)
    ref = jax.device_get(JS._log_aux(jstate))
    got = TS.log_aux(tstate)
    for name in ("dyn_w", "dyn_mean", "dyn_cov", "map_w", "log_weights"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def _scene(cfg, rng):
    state = TState.create(cfg)
    sc = simdata.make_scenario(rng, n_landmarks=12, n_steps=4,
                               clutter_rate=2.0)
    _, meas, _ = simdata.generate_mixed_run(
        rng, sc, np.array([[4.0, 1.0]]), np.array([[0.0, 0.3]]),
        control_noise=(0.05, 0.005))
    return state, [_z(m, cfg.maxMeasurements)[1] for m in meas[:3]]


@pytest.mark.parametrize("feature_model", [0, 2])
def test_select_by_index_matches_payload_mode(mixed_cfg, feature_model):
    """select_by_index = 1 (the by-index kernels, payload gathered by the
    caller) and 0 (the payload kernels) give the same steps: the gather
    repeats the kernels' arithmetic on the same slots."""
    rng = np.random.default_rng(3)
    cfg = mixed_cfg.replace(featureModel=feature_model,
                            particleWeighting=2 if feature_model == 0 else 0)
    state, zs = _scene(cfg, rng)
    out = {}
    for by_index in (False, True):
        c = cfg.replace(selectByIndex=by_index)
        s = state
        g = torch.Generator().manual_seed(0)
        for t, z in enumerate(zs):
            s, _ = TS.slam_step(s, (1.0, 0.05), z, 1.0, t > 0, c,
                                generator=g)
        out[by_index] = s
    a, b = out[False], out[True]
    for x, y in zip(state_to_numpy(a)["map_static"].values(),
                    state_to_numpy(b)["map_static"].values()):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)
    for x, y in zip(state_to_numpy(a)["map_dynamic"].values(),
                    state_to_numpy(b)["map_dynamic"].values()):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(a.log_weights, b.log_weights, rtol=1e-6,
                               atol=1e-7)
    assert float(a.map_static.w.sum()) > 0


def test_phd_update_static_by_index_uses_gather(mixed_cfg):
    """The static update under select_by_index runs the by-index select
    kernel and no payload kernel."""
    from phdslam_tpu_torch.kernels import select as S
    rng = np.random.default_rng(4)
    cfg = mixed_cfg.replace(featureModel=0, selectByIndex=True)
    state, zs = _scene(cfg, rng)
    z = zs[0]
    calls = []
    orig = S.select_plain
    try:
        S.select_plain = lambda *a, **kw: calls.append(kw["by_index"]) \
            or orig(*a, **kw)
        TU.phd_update_static(state.pose, state.map_static, z.rb, z.label,
                             z.valid, cfg)
    finally:
        S.select_plain = orig
    assert calls == [True]


def test_run_scan_confirms_mover():
    """tests/test_mixed.py::test_shipped_mixed_cfg_confirms_mover on the
    port: the shipped mixed knobs at 64 particles x 32 slots x 32
    measurements, 40 steps of a mover beside three landmarks with clutter;
    on at least 0.9 of the steps from 8 on, a dynamic component of weight
    >= 0.05 lies within 2 m of the mover (JAX measured 1.00)."""
    cfg = load_config("cfg/mixed_synth.cfg").replace(
        n_particles=64, maxFeatures=32, maxMeasurements=32,
        x0=0.0, y0=0.0, yaw0=0.0)
    rng = np.random.default_rng(5)
    T = 40
    landmarks = np.array([[5.0, -2.0], [7.0, 1.0], [4.0, 3.0]])
    mover0 = np.array([6.5, -4.0])
    mv = np.array([0.0, 0.25])
    M = cfg.maxMeasurements
    rb = np.zeros((T, M, 2), np.float32)
    valid = np.zeros((T, M), bool)
    truth = np.zeros((T, 2))
    for t in range(T):
        pos = mover0 + mv * t * cfg.dt
        truth[t] = pos
        pts = [pos] + [lm for lm in landmarks if rng.uniform() < cfg.pd]
        zs = [[np.linalg.norm(p) + rng.normal(0, cfg.stdRange),
               np.arctan2(p[1], p[0]) + rng.normal(0, cfg.stdBearing)]
              for p in pts]
        for _ in range(rng.poisson(cfg.clutterRate)):
            zs.append([rng.uniform(0.5, cfg.maxRange),
                       rng.uniform(-cfg.maxBearing, cfg.maxBearing)])
        for i, z in enumerate(zs[:M]):
            rb[t, i] = z
            valid[t, i] = True
    zs = [TMeas.from_numpy(rb[t], np.zeros(M, np.int32), valid[t])
          for t in range(T)]
    _, (_, la) = TS.run_scan(TState.create(cfg), np.zeros((T, 2)), zs,
                             np.full(T, cfg.dt), cfg,
                             generator=torch.Generator().manual_seed(0),
                             with_log_state=True)
    dyn_w, dyn_m = la.dyn_w.numpy(), la.dyn_mean.numpy()
    confirmed = []
    for t in range(8, T):
        sel = dyn_w[t] >= 0.05
        dd = np.linalg.norm(dyn_m[t].T[sel][:, :2] - truth[t], axis=1)
        confirmed.append(bool(sel.any() and dd.min() < 2.0))
    assert np.mean(confirmed) >= 0.9, confirmed


@pytest.fixture(scope="module")
def mixed_dataset(tmp_path_factory):
    sc = simdata.make_scenario(np.random.default_rng(11), n_landmarks=12,
                               n_steps=12, clutter_rate=2.0)
    # seed 23: every step has a measurement (the text loader skips an
    # empty line, which would shift the steps)
    controls, meas, _ = simdata.generate_mixed_run(
        np.random.default_rng(23), sc, np.array([[3.0, -3.0]]),
        np.array([[0.1, 0.3]]), control_noise=(0.05, 0.005))
    assert all(len(z) for z in meas)
    d = tmp_path_factory.mktemp("mixedrun")
    simdata.write_run_files(str(d), controls, meas)
    with open("cfg/mixed_synth.cfg") as f:
        base = f.read()
    (d / "tiny.cfg").write_text(base + "\nn_particles = 8\nmax_features = 16"
                                "\nmax_measurements = 8\ninitial_y = 0.0\n")
    return len(meas), d


@pytest.mark.parametrize("mode", ["loop", "scan"])
def test_mixed_runner_writes_dynamic_map(mixed_dataset, tmp_path, mode):
    """Log line 3 holds the MAP particle's dynamic map (weight, 4-D mean,
    column-major 4x4 covariance per component) and agrees with the final
    state's dynamic map."""
    T, d = mixed_dataset
    out = tmp_path / mode
    res = runner.main([str(d / "tiny.cfg"), "synth", "--measurements",
                       str(d / "measurements.txt"), "--controls",
                       str(d / "controls.txt"), "--data-dir", str(d),
                       "--out-dir", str(out), "--device", "cpu", "--mode",
                       mode, "--seed", "1"])
    with open(out / "metrics.jsonl") as f:
        assert len([json.loads(line) for line in f]) == T
    logs = [read_state_estimate_log(str(out / f"state_estimate{t:05d}.log"))
            for t in range(T)]
    assert all(lg["dynamic"].shape[1] == 21 for lg in logs)
    assert max(len(lg["dynamic"]) for lg in logs) > 0
    last = logs[-1]["dynamic"]
    la = TS.log_aux(res["state"])
    w = la.dyn_w.numpy()
    np.testing.assert_allclose(last[:, 0], w[w > 0], rtol=1e-5)
    np.testing.assert_allclose(last[:, 1:5], la.dyn_mean.numpy().T[w > 0],
                               rtol=1e-5, atol=1e-5)
    cov = runner.unpack_cov_channels(la.dyn_cov.numpy())[w > 0]
    np.testing.assert_allclose(last[:, 5:].reshape(-1, 4, 4),
                               np.swapaxes(cov, 1, 2), rtol=1e-5, atol=1e-5)
    assert os.path.exists(out / "loopTime.log")


def test_runner_refuses_missing_cuda(mixed_dataset, tmp_path):
    """The default device is cuda; without CUDA the runner raises rather
    than falling back to the CPU."""
    _, d = mixed_dataset
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="--device cpu"):
        runner.main([str(d / "tiny.cfg"), "synth", "--measurements",
                     str(d / "measurements.txt"), "--controls",
                     str(d / "controls.txt"), "--out-dir",
                     str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()

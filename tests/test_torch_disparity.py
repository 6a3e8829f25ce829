"""The port's disparity (monocular SC-PHD) pipeline against
``phdslam_tpu.filter.disparity`` at a tiny size, with JAX's random draws
replayed into the port, and the port's runner in loop and scan mode on a
small dataset written by its own ``simdata``.

JAX derives one step's draws as k_pred, k_sample, k_res = split(key, 3):
normal(k_pred, (P, 6)) pose noise, normal(k_sample, (P, F, Npp, 3)) cloud
noise, uniform(k_res, (P,)) resample uniforms; the test makes them with
jax.random and hands them to the port as ``noise``. Both configurations come
from cfg/disparity_synth.cfg through each package's own loader, cut to
4 particles x 8 slots x 8 points x 8 measurements. Top-k ties: the port
reproduces ``jax.lax.top_k``'s order (stable descending sort), so every
slot is compared, empty ones included.

Tolerances: poses rtol 1e-5 / atol 1e-5 (float32 trigonometry); weights
rtol 1e-4 / atol 1e-5 (normalisers over exp of pixel-scale quadratic
forms); clouds rtol 1e-4 / atol 1e-3 metres (disparity -> world divides by
d ~ 100-300, and the merge moments round differently: one pass centred on
the pick against JAX's mean first); resample indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.config import load_config as jax_load_config
from phdslam_tpu.filter import disparity as JD
from phdslam_tpu_torch import load_config, runner, simdata
from phdslam_tpu_torch.bridge import (disparity_state_from_numpy,
                                      disparity_state_to_numpy)
from phdslam_tpu_torch.filter import disparity as TD
from phdslam_tpu_torch.filter.state import Measurements
from phdslam_tpu_torch.io.logs import read_state_estimate_log

torch.set_num_threads(1)

CFG = "cfg/disparity_synth.cfg"
TINY = dict(n_particles=4, maxFeatures=8, particlesPerFeature=8,
            maxMeasurements=8)
TINY_CFG_TEXT = """
n_particles = 4
max_features = 8
particles_per_feature = 8
max_measurements = 8
"""
TOL_POSE = dict(rtol=1e-5, atol=1e-5)
TOL_W = dict(rtol=1e-4, atol=1e-5)
TOL_CLOUD = dict(rtol=1e-4, atol=1e-3)
T_RUN = 12


@pytest.fixture(scope="module")
def cfgs():
    return (jax_load_config(CFG).replace(**TINY),
            load_config(CFG).replace(**TINY))


@pytest.fixture(scope="module")
def scenario():
    sc = simdata.make_disparity_scenario(np.random.default_rng(3),
                                         n_landmarks=8, n_steps=T_RUN)
    meas = simdata.generate_disparity_run(np.random.default_rng(4), sc)
    assert all(len(z) for z in meas)
    return sc, meas


def _z(meas_t, M):
    uv = np.zeros((M, 2), np.float32)
    valid = np.zeros(M, bool)
    k = min(len(meas_t), M)
    uv[:k] = meas_t[:k]
    valid[:k] = True
    return uv, valid


def test_fit_gaussians_matches_jax(rng):
    pts = rng.normal(300, 40, (5, 7, 64, 3)).astype(np.float32)
    ref = JD.fit_gaussians(*(jnp.asarray(pts[..., i]) for i in range(3)))
    got = TD.fit_gaussians(*(torch.as_tensor(pts[..., i]) for i in range(3)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-3)


def test_sample_gaussians_matches_jax_on_replayed_normals(rng):
    P, F, npp = 3, 5, 16
    m = [rng.uniform(100, 500, (P, F)).astype(np.float32) for _ in range(3)]
    a = rng.normal(size=(P, F, 3, 3)) * 3.0
    cov = a @ np.swapaxes(a, -1, -2) + np.eye(3)
    c = [cov[..., i, j].astype(np.float32)
         for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]
    key = jax.random.PRNGKey(7)
    ref = JD.sample_gaussians(key, *(jnp.asarray(x) for x in m + c), npp)
    x = np.array(jax.random.normal(key, (P, F, npp, 3), jnp.float32))
    got = TD.sample_gaussians(torch.as_tensor(x),
                              *(torch.as_tensor(v) for v in m + c))
    for g, r in zip(got, ref):
        assert g.shape == (P, F, npp)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-4)


def _draws(key, P, F, npp):
    k_pred, k_sample, k_res = jax.random.split(key, 3)
    as_t = lambda a: torch.as_tensor(np.array(a))
    return (as_t(jax.random.normal(k_pred, (P, 6), jnp.float32)),
            as_t(jax.random.normal(k_sample, (P, F, npp, 3), jnp.float32)),
            as_t(jax.random.uniform(k_res, (P,), jnp.float32)))


def _compare(tstate, jstate, tag):
    j = jax.device_get(jstate)
    np.testing.assert_allclose(tstate.pose.numpy(), j.pose, err_msg=tag,
                               **TOL_POSE)
    np.testing.assert_allclose(tstate.log_weights.numpy(), j.log_weights,
                               err_msg=tag, **TOL_W)
    np.testing.assert_allclose(tstate.w.numpy(), j.w, err_msg=tag, **TOL_W)
    np.testing.assert_array_equal(tstate.resample_idx.numpy(),
                                  j.resample_idx, err_msg=tag)
    for name in ("px", "py", "pz"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   getattr(j, name), err_msg=f"{tag} {name}",
                                   **TOL_CLOUD)


@pytest.mark.parametrize("weighting,merge_mode", [(0, 0), (1, 1)])
def test_three_steps_match_jax(cfgs, scenario, weighting, merge_mode):
    """The shipped knobs (particle_weighting 0, exact merge), then the
    cardinality-difference weighting with the fast merge's prune."""
    jcfg, tcfg = (c.replace(particleWeighting=weighting,
                            mergeMode=merge_mode) for c in cfgs)
    _, meas = scenario
    P, F, npp = tcfg.n_particles, tcfg.maxFeatures, tcfg.particlesPerFeature
    jstate = JD.DisparityState.create(jcfg)
    jitter = np.random.default_rng(9).uniform(-0.03, 0.03, (P, 2))
    pose = np.asarray(jstate.pose).copy()
    pose[:, 3] += jitter[:, 0]
    pose[:, 5] += jitter[:, 1]
    jstate = jstate.replace(pose=jnp.asarray(pose, jnp.float32))
    tstate = disparity_state_from_numpy(jax.device_get(jstate))
    key = jax.random.PRNGKey(5)
    for t in range(3):
        key, sk = jax.random.split(key)
        uv, valid = _z(meas[t], tcfg.maxMeasurements)
        jstate, jaux = JD.disparity_step(
            jstate, sk, jnp.asarray(uv), jnp.asarray(valid),
            jnp.float32(jcfg.dt), jnp.asarray(t > 0), jcfg)
        tstate, taux = TD.disparity_step(
            tstate, Measurements.from_numpy(uv, np.zeros(len(uv)), valid),
            float(np.float32(tcfg.dt)), t > 0, tcfg,
            noise=_draws(sk, P, F, npp))
        _compare(tstate, jstate, f"step {t}")
        np.testing.assert_allclose(taux.expected_pose.numpy(),
                                   np.asarray(jaux.expected_pose), **TOL_POSE)
        np.testing.assert_allclose(float(taux.neff), float(jaux.neff),
                                   **TOL_W)
        assert float(taux.n_measure) == float(jaux.n_measure)
    assert float(tstate.w.sum()) > 0


def test_step_without_measurements_keeps_map_and_weights(cfgs, scenario):
    """A step with no measurement moves the cameras but leaves the map, the
    weights and the lineage untouched."""
    _, tcfg = cfgs
    _, meas = scenario
    g = torch.Generator().manual_seed(0)
    state = TD.DisparityState.create(tcfg)
    uv, valid = _z(meas[0], tcfg.maxMeasurements)
    state, _ = TD.disparity_step(
        state, Measurements.from_numpy(uv, np.zeros(len(uv)), valid), 1.0,
        False, tcfg, generator=g)
    empty = Measurements.empty(tcfg.maxMeasurements)
    moved, aux = TD.disparity_step(state, empty, 1.0, True, tcfg,
                                   generator=g)
    for name in ("w", "px", "py", "pz", "log_weights"):
        assert torch.equal(getattr(moved, name), getattr(state, name)), name
    assert not torch.equal(moved.pose, state.pose)
    assert float(aux.n_measure) == 0
    np.testing.assert_array_equal(moved.resample_idx.numpy(),
                                  np.arange(tcfg.n_particles))


def test_bridge_round_trip(cfgs):
    jcfg, _ = cfgs
    host = jax.device_get(JD.DisparityState.create(jcfg))
    tstate = disparity_state_from_numpy(host)
    assert tstate.resample_idx.dtype == torch.int32
    back = disparity_state_to_numpy(tstate)
    for name, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(host, name)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, scenario):
    sc, meas = scenario
    d = tmp_path_factory.mktemp("disprun")
    simdata.write_disparity_files(str(d), sc, meas)
    with open(CFG) as f:
        (d / "tiny.cfg").write_text(f.read() + TINY_CFG_TEXT)
    return d


def test_runner_loop_and_scan_agree(dataset, tmp_path):
    """The same seed gives the same draws in both modes, so the logs are
    the same files; the log contract holds (12-DOF pose line, map stride
    13, metrics per step)."""
    outs = {}
    for mode in ("loop", "scan"):
        outs[mode] = out = tmp_path / mode
        runner.main([str(dataset / "tiny.cfg"), "disparity", "--data-dir",
                     str(dataset), "--out-dir", str(out), "--device", "cpu",
                     "--mode", mode, "--seed", "2"])
        assert len(np.loadtxt(out / "loopTime.log")) == T_RUN
        assert len((out / "metrics.jsonl").read_text().splitlines()) == T_RUN
    traj = np.loadtxt(dataset / "traj.txt", comments="%")
    errs = []
    for t in range(T_RUN):
        name = f"state_estimate{t:05d}.log"
        loop_text = (outs["loop"] / name).read_text()
        assert loop_text == (outs["scan"] / name).read_text(), name
        log = read_state_estimate_log(str(outs["loop"] / name))
        assert log["pose"].shape == (12,) and log["poses"].shape == (4, 12)
        assert log["static"].shape[1] == 13
        errs.append(np.linalg.norm(log["pose"][:3] - traj[t, :3]))
    assert np.isfinite(errs).all() and np.mean(errs) < 1.5, errs
    assert log["static"].shape[0] > 0


@pytest.mark.parametrize("extra", [("--resume",), ("--checkpoint-every",
                                                   "5")])
def test_runner_refuses_checkpoints(dataset, tmp_path, extra):
    with pytest.raises(NotImplementedError, match="item 13"):
        runner.main([str(dataset / "tiny.cfg"), "disparity", "--data-dir",
                     str(dataset), "--out-dir", str(tmp_path / "out"),
                     "--device", "cpu", *extra])
    assert not (tmp_path / "out" / "loopTime.log").exists()

"""The port's Monte-Carlo batch harness (``phdslam_tpu_torch/eval/batch.py``)
against the JAX package's (``phdslam_tpu/eval/batch.py``): the host
helpers give the same results on the same inputs (exactly: they are the
same numpy code over the same data), and ``run_batch`` on a tiny cfg meets
``tests/test_aux.py::test_batch_harness_and_plots``'s assertions on the
CPU. The filter itself is held to JAX's by the step tests; its random
streams differ (``torch.Generator`` against ``PRNGKey``), so whole batches
are compared only by their statistics (``chip_smoke.py``'s Monte-Carlo
envelope on the card)."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from phdslam_tpu import simdata as JSD
from phdslam_tpu.config import load_config as jax_load_config
from phdslam_tpu.eval import batch as JB
from phdslam_tpu.io import logs as JLG
from phdslam_tpu_torch import load_config, simdata
from phdslam_tpu_torch.eval import batch as TB

torch.set_num_threads(1)

TINY = dict(n_particles=8, maxFeatures=16, maxMeasurements=8,
            birthWeight=1e-3, y0=0.0)


@pytest.fixture(scope="module")
def scenario():
    return (JSD.make_scenario(np.random.default_rng(0), n_landmarks=8,
                              n_steps=15, clutter_rate=1.0),
            simdata.make_scenario(np.random.default_rng(0), n_landmarks=8,
                                  n_steps=15, clutter_rate=1.0))


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("run", [0, 3])
def test_prepare_run_matches_jax(scenario, run):
    """Run r's re-noised controls and padded measurements: the same arrays
    (default_rng(seed + 1000 r) in both)."""
    jsc, tsc = scenario
    t_len = jsc.traj.shape[0]
    ref = JB._prepare_run(jax_load_config("cfg/ackerman_synth.cfg").replace(
        **TINY), jsc, run, 5, (0.2, 0.01), t_len)
    got = TB._prepare_run(load_config("cfg/ackerman_synth.cfg").replace(
        **TINY), tsc, run, 5, (0.2, 0.01), t_len)
    _equal(list(got), list(ref))
    assert [a.dtype for a in got] == [a.dtype for a in ref]


def test_visited_landmarks_and_analyze_run_match_jax(scenario):
    jsc, tsc = scenario
    ref_maps, got_maps = JB.visited_landmarks(jsc), TB.visited_landmarks(tsc)
    _equal(got_maps, ref_maps)
    rng = np.random.default_rng(2)
    t_len = jsc.traj.shape[0]
    poses = jsc.traj + rng.normal(0, 0.3, jsc.traj.shape)
    est = [(rng.uniform(0, 1.2, 6), rng.normal(0, 8, (6, 2)))
           for _ in range(t_len)]
    _equal(TB.analyze_run(poses, tsc.traj, est, got_maps),
           JB.analyze_run(poses, jsc.traj, est, ref_maps))
    _equal(TB.analyze_run(poses[:-3], tsc.traj),
           JB.analyze_run(poses[:-3], jsc.traj))


def _fake_run(t_len, seed, cphd):
    """Per-step MAP maps (and a cardinality log-pmf) as a run would log."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 1, (t_len, 10)) * (rng.uniform(size=(t_len, 10)) > .3)
    cn = (np.log(rng.dirichlet(np.ones(9), t_len)) if cphd
          else np.zeros((t_len, 1)))
    return SimpleNamespace(map_w=w.astype(np.float32),
                           map_mx=rng.normal(0, 8, (t_len, 10)),
                           map_my=rng.normal(0, 8, (t_len, 10)),
                           cardinality=cn)


@pytest.mark.parametrize("every", [1, 4])
def test_map_ospa_curve_matches_jax(scenario, every):
    jsc, tsc = scenario
    t_len = jsc.traj.shape[0]
    la = _fake_run(t_len, every, False)
    _equal(TB._map_ospa_curve(la, TB.visited_landmarks(tsc), every, t_len),
           JB._map_ospa_curve(la, JB.visited_landmarks(jsc), every, t_len))


@pytest.mark.parametrize("cphd", [False, True])
def test_analyze_one_and_aggregate_match_jax(scenario, tmp_path, cphd):
    """Per-run post-processing (pose error, OSPA curve, cardinality error,
    the batch_metrics.jsonl line) and the envelopes over runs."""
    jsc, tsc = scenario
    t_len = jsc.traj.shape[0]
    out = {}
    for name, mod, sc in (("jax", JB, jsc), ("port", TB, tsc)):
        maps = mod.visited_landmarks(sc)
        rs = []
        for run in range(3):
            rng = np.random.default_rng(run)
            poses = sc.traj + rng.normal(0, 0.2, sc.traj.shape)
            rs.append(mod._analyze_one(
                run, poses, rng.uniform(size=t_len),
                _fake_run(t_len, run, cphd), maps, 2, sc, 1.5,
                str(tmp_path / name)))
        out[name] = (rs, mod.aggregate(rs))
    for a, b in zip(out["port"][0], out["jax"][0]):
        _equal({k: v for k, v in vars(a).items() if v is not None},
               {k: v for k, v in vars(b).items() if v is not None})
        assert [k for k, v in vars(a).items() if v is None] == \
            [k for k, v in vars(b).items() if v is None]
    _equal(out["port"][1], out["jax"][1])
    assert (tmp_path / "port" / "batch_metrics.jsonl").read_text() == \
        (tmp_path / "jax" / "batch_metrics.jsonl").read_text()


def test_analyze_log_dir_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    traj = rng.normal(0, 5, (3, 4))
    for t in range(4):
        k = 3 if t else 0
        JLG.write_state_estimate_log(
            str(tmp_path), t, np.r_[traj[:2, t] + 0.1, 0, 0, 0, 0],
            rng.uniform(0.2, 1, k), rng.normal(0, 5, (k, 2)),
            np.tile(np.eye(2) * 0.1, (k, 1, 1)),
            particle_log_weights=np.log(rng.dirichlet(np.ones(4))),
            particle_poses=rng.normal(0, 1, (4, 6)),
            resample_idx=np.arange(4), max_cardinality=4)
    truth = rng.normal(0, 5, (5, 2))
    _equal(TB.analyze_log_dir(str(tmp_path), traj, truth),
           JB.analyze_log_dir(str(tmp_path), traj, truth))
    _equal(TB.analyze_log_dir(str(tmp_path), traj),
           JB.analyze_log_dir(str(tmp_path), traj))


def test_run_batch_harness_and_plots(scenario, tmp_path):
    """test_aux.py::test_batch_harness_and_plots on the port, on the CPU."""
    _, sc = scenario
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        **TINY, stdEncoder=0.05, stdAlpha=0.005)
    results = TB.run_batch(cfg, sc, n_runs=2, control_noise=(0.05, 0.005),
                           out_dir=str(tmp_path), device="cpu")
    assert len(results) == 2
    for r in results:
        assert np.isfinite(r.pose_err).all()
        assert np.isfinite(r.ospa).all(), r.ospa
        assert (r.ospa[:, 0] >= 0).all()
        assert r.ms_per_step > 0 and r.poses.shape == (16, 6)
    agg = TB.aggregate(results)
    assert agg["pose_err_mean"].shape == (16,)
    assert "ospa_mean" in agg and np.isfinite(agg["ospa_mean"]).all()
    assert os.path.exists(tmp_path / "batch_metrics.jsonl")
    rec = json.loads(open(tmp_path / "batch_metrics.jsonl").readline())
    assert rec["mean_ospa"] is not None and np.isfinite(rec["mean_ospa"])
    pytest.importorskip("matplotlib")
    from phdslam_tpu_torch.eval.plots import plot_error_curves
    out = plot_error_curves(agg, str(tmp_path / "errors.png"))
    assert os.path.exists(out)

"""The port's runner on the CPU over a small self-generated ``simdata`` run
(the scenario of tests/test_e2e.py): the log contract, and tracking within
that test's bar (mean pose error < 2.0 m). No reference data is read."""

import json
import os

import numpy as np
import pytest
import torch

from phdslam_tpu_torch import _shared, runner

torch.set_num_threads(1)

T = 40
TINY = """
n_particles = 8
max_features = 16
max_measurements = 8
birth_weight = 0.02
std_encoder = 0.05
std_alpha = 0.005
initial_y = 0.0
"""


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    sc = _shared.make_scenario(np.random.default_rng(11), n_landmarks=12,
                               n_steps=T, clutter_rate=2.0)
    # seed 21: every step has a measurement (the shared text loader skips
    # an empty line, which would shift the steps against the truth)
    controls, meas = _shared.generate_run(np.random.default_rng(21), sc,
                                          control_noise=(0.05, 0.005))
    assert all(len(z) for z in meas[:T])
    d = tmp_path_factory.mktemp("simrun")
    _shared.write_run_files(str(d), controls, meas[:T])
    with open("cfg/ackerman_synth.cfg") as f:
        base = f.read()
    (d / "tiny.cfg").write_text(base + TINY)
    return sc, d


def _args(d, out, *extra):
    return [str(d / "tiny.cfg"), "synth", "--measurements",
            str(d / "measurements.txt"), "--controls",
            str(d / "controls.txt"), "--out-dir", str(out), "--device",
            "cpu", *extra]


@pytest.mark.parametrize("mode", ["loop", "scan"])
def test_runner_log_contract_and_tracking(dataset, tmp_path, mode):
    sc, d = dataset
    out = tmp_path / mode
    runner.main(_args(d, out, "--mode", mode, "--seed", "3"))
    logs = sorted(p for p in os.listdir(out)
                  if p.startswith("state_estimate"))
    assert logs == [f"state_estimate{t:05d}.log" for t in range(T)]
    with open(out / "loopTime.log") as f:
        assert len(f.read().split()) == T
    with open(out / "metrics.jsonl") as f:
        metrics = [json.loads(line) for line in f]
    assert [m["t"] for m in metrics] == list(range(T))
    assert all(np.isfinite(m["neff"]) for m in metrics)
    errs = []
    for t in range(T):
        log = _shared.read_state_estimate_log(
            str(out / f"state_estimate{t:05d}.log"))
        assert log["weights"].shape == (8,)
        assert log["poses"].shape == (8, 6)
        assert log["resample_idx"].shape == (8,)
        assert log["static"].shape[1] == 7
        errs.append(np.linalg.norm(log["pose"][:2] - sc.traj[t, :2]))
    errs = np.asarray(errs)
    assert np.isfinite(errs).all()
    assert errs.mean() < 2.0, errs
    # landmarks were mapped: the last MAP map holds mass
    assert log["static"][:, 0].sum() > 0.5


@pytest.mark.parametrize("extra_cfg,extra_args,match", [
    ("filter_type = 1", (), "item 9"),
    ("filter_type = 2", (), "item 11"),
    ("feature_model = 2", (), "item 10"),
    ("select_by_index = 1", (), "Queue 2"),
    ("map_estimate = 3", (), "item 8"),
    ("", ("--truth", "truth.txt"), "item 8"),
    ("", ("--islands", "4"), "item 14"),
    ("", ("--resume",), "item 13"),
])
def test_uncovered_branches_raise(dataset, tmp_path, extra_cfg, extra_args,
                                  match):
    """A branch outside the static slice raises NotImplementedError naming
    the ROADMAP item that ports it; nothing else runs in its place."""
    _, d = dataset
    cfg = tmp_path / "x.cfg"
    cfg.write_text((d / "tiny.cfg").read_text() + "\n" + extra_cfg + "\n")
    args = _args(d, tmp_path / "out", *extra_args)
    args[0] = str(cfg)
    with pytest.raises(NotImplementedError, match=match):
        runner.main(args)
    assert not (tmp_path / "out" / "loopTime.log").exists()


def test_schedule_lockstep_and_interleave():
    lock = runner.schedule_inputs(3, None, None)
    assert [(s["z"], s["c"]) for s in lock] == [(0, None), (1, 0), (2, 1)]
    inter = runner.schedule_inputs(
        5, np.array([0.5, 1.0, 3.0]), np.array([1.0, 2.0, 3.0]))
    assert [(s["z"], s["c"], s["dt"]) for s in inter] == [
        (0, None, 1.0), (1, 0, 0.0), (None, 1, 1.0), (2, 2, 1.0)]

"""The port's own copies of the JAX package's host modules (``config.py``,
``simdata.py``, ``io/loaders.py``, ``io/logs.py``) against the originals:
the same cfg fields, the same arrays from one seed, the same parsed files,
the same log bytes. Exact comparisons: the copies run the same numpy code."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from phdslam_tpu import config as JC
from phdslam_tpu import simdata as JSD
from phdslam_tpu.io import loaders as JL
from phdslam_tpu.io import logs as JLG
from phdslam_tpu_torch import config as TC
from phdslam_tpu_torch import simdata as TSD
from phdslam_tpu_torch.io import loaders as TL
from phdslam_tpu_torch.io import logs as TLG

CFGS = sorted(glob.glob("cfg/*.cfg"))


@pytest.mark.parametrize("path", CFGS, ids=[os.path.basename(p)
                                            for p in CFGS])
def test_load_config_matches_jax(path):
    ref = dataclasses.asdict(JC.load_config(path))
    got = dataclasses.asdict(TC.load_config(path))
    assert got == ref
    assert TC.load_config(path).replace(maxRange=5.0).clutterDensity == \
        JC.load_config(path).replace(maxRange=5.0).clutterDensity


def _assert_tree_equal(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["static", "mixed"])
def test_simdata_matches_jax(kind):
    """make_scenario, then generate_run or generate_mixed_run (with labels)
    from the same seeds."""
    def run(mod):
        sc = mod.make_scenario(np.random.default_rng(4), n_landmarks=10,
                               n_steps=15, clutter_rate=3.0)
        rng = np.random.default_rng(9)
        if kind == "static":
            out = mod.generate_run(rng, sc, control_noise=(0.1, 0.01))
        else:
            out = mod.generate_mixed_run(
                rng, sc, np.array([[6.0, 0.0], [2.0, 3.0]]),
                np.array([[0.0, 0.2], [0.1, -0.1]]),
                control_noise=(0.1, 0.01), return_labels=True)
        return [sc.landmarks, sc.traj, sc.controls_true], list(out)

    _assert_tree_equal(run(TSD), run(JSD))


def test_loaders_match_jax(tmp_path):
    """Every loader on files the simdata writer makes (an empty measurement
    line included, which both loaders drop), labeled triples, timestamps,
    a trajectory and the padding."""
    sc = JSD.make_scenario(np.random.default_rng(2), n_landmarks=8,
                           n_steps=10, clutter_rate=1.0)
    controls, meas = JSD.generate_run(np.random.default_rng(3), sc)
    meas[4] = meas[4][:0]
    JSD.write_run_files(str(tmp_path), controls, meas)
    (tmp_path / "lab.txt").write_text(
        "% r b label\n1.0 0.1 0\n2.0 -0.2 1 3.0 0.3 0\n\n4.0 0.0 1\n")
    (tmp_path / "times.txt").write_text("0.5\n1.0\n2.5\n\n")
    (tmp_path / "traj.txt").write_text(
        "% px py pt vx vy vt\n" + "\n".join(
            " ".join(str(v) for v in row) for row in np.concatenate(
                [sc.traj[:5], np.zeros((5, 3))], 1)) + "\n")
    for mod_args in (("load_measurements", "measurements.txt", {}),
                     ("load_measurements", "lab.txt", {"labeled": True}),
                     ("load_controls", "controls.txt", {}),
                     ("load_timestamps", "times.txt", {}),
                     ("load_timestamps", "missing.txt", {}),
                     ("load_trajectory", "traj.txt", {})):
        name, fname, kw = mod_args
        ref = getattr(JL, name)(str(tmp_path / fname), **kw)
        got = getattr(TL, name)(str(tmp_path / fname), **kw)
        if name == "load_measurements":
            assert len(got) == len(ref)
            for g, r in zip(got, ref):
                _assert_tree_equal(list(dataclasses.astuple(g)),
                                   list(dataclasses.astuple(r)))
            sets = (got, ref)
        elif ref is None:
            assert got is None
        else:
            assert len(ref)
            np.testing.assert_array_equal(got, ref)
    _assert_tree_equal(list(TL.pad_measurement_sets(sets[0], 3)),
                       list(JL.pad_measurement_sets(sets[1], 3)))


def test_write_state_estimate_log_same_bytes(tmp_path):
    """Both writers, with a static and a dynamic map, the t = 0 repeat and
    the PHD cardinality line; then the loop-time and metrics appenders."""
    rng = np.random.default_rng(0)
    f, fd, P = 5, 3, 4
    args = dict(
        expected_pose=rng.normal(size=6).astype(np.float32),
        static_w=rng.uniform(0, 1, f), static_mean=rng.normal(size=(f, 2)),
        static_cov=rng.normal(size=(f, 2, 2)),
        dynamic_w=np.array([0.5, 0.0, 0.25]),
        dynamic_mean=rng.normal(size=(fd, 4)),
        dynamic_cov=rng.normal(size=(fd, 4, 4)),
        particle_log_weights=np.log(np.full(P, 1.0 / P, np.float32)),
        particle_poses=rng.normal(size=(P, 6)).astype(np.float32),
        resample_idx=np.arange(P), max_cardinality=7, repeat=2)
    out = {}
    for tag, mod in (("jax", JLG), ("port", TLG)):
        d = tmp_path / tag
        d.mkdir()
        mod.write_state_estimate_log(str(d), 3, **args)
        mod.append_loop_time(str(d), 1.234567)
        mod.append_metrics_jsonl(str(d), dict(t=3, ms=1.5))
        out[tag] = {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}
    assert out["port"] == out["jax"]
    assert len(out["jax"]) == 3
    log = TLG.read_state_estimate_log(str(tmp_path / "port"
                                          / "state_estimate00003.log"))
    assert log["dynamic"].shape == (2, 21)

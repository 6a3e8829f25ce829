"""The port's benchmark (``phdslam_tpu_torch/bench.py``) against the JAX
package's ``bench.py``: the same headline config field for field, the same
stress stream, the same CPU-anchor key, ``bench.py``'s contract checks
(``tests/test_bench_contract.py``) on the port's module; its runner on the
CPU at 32 x 32 x 16; the CPU reference on a key miss; and no run without a
CUDA device (the stage profile's too)."""

import dataclasses
import inspect
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from phdslam_tpu_torch import bench as TB
from phdslam_tpu_torch import stage_profile as TP

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench as JB  # noqa: E402

torch.set_num_threads(1)

PINNED_KEY = "167dbf7bcd88e62a"


def test_dense_stress_config_matches_jax():
    assert dataclasses.asdict(TB.dense_stress_config()) == \
        dataclasses.asdict(JB.dense_stress_config())
    assert TB.STRESS_OVERRIDES == JB.STRESS_OVERRIDES


@pytest.mark.parametrize("seed", [0, 3])
def test_make_stress_inputs_matches_jax(seed):
    cfg = TB.dense_stress_config()
    for a, b in zip(TB.make_stress_inputs(cfg, 19, seed),
                    JB.make_stress_inputs(cfg, 19, seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_anchor_key_is_pinned():
    """The dense config at 32 particles over 4 steps hashes to the pinned
    anchor's key, so the benchmark reads it and runs no CPU reference."""
    cfg = TB.dense_stress_config()
    assert TB.anchor_key(cfg.replace(n_particles=32), 4) == PINNED_KEY
    anchor = json.loads(TB.ANCHOR.read_text())
    assert anchor["key"] == PINNED_KEY
    ms, p, how = TB.bench_cpu_reference(cfg)
    assert (ms, p, how) == (anchor["ms_per_step"], 32, "pinned")


# bench.py's contract (tests/test_bench_contract.py) on the port's module

def test_headline_config_matches_shipped_defaults():
    from phdslam_tpu_torch.config import load_config
    shipped = load_config("cfg/ackerman_synth.cfg")
    stress = TB.dense_stress_config()
    drift = {
        f.name: (getattr(shipped, f.name), getattr(stress, f.name))
        for f in dataclasses.fields(shipped)
        if f.name not in TB.STRESS_OVERRIDES
        and getattr(shipped, f.name) != getattr(stress, f.name)
    }
    assert not drift, (
        "bench headline config drifted from shipped defaults on "
        f"non-shape fields: {drift}")


def test_stress_overrides_are_shape_only():
    semantic = {"mergeMode", "selectTopK", "usePallas", "mergeCompactK",
                "minSeparation", "minFeatureWeight", "mergeMinWeight",
                "filterType", "motionType", "mapType", "weightingScheme"}
    assert not semantic & set(TB.STRESS_OVERRIDES)


def test_main_uses_dense_stress_config():
    assert "dense_stress_config()" in inspect.getsource(TB.main)


@pytest.mark.parametrize("mod", [TB, TP], ids=["bench", "stage_profile"])
@pytest.mark.parametrize("argv", [[], ["--quick"]])
def test_main_refuses_without_cuda(monkeypatch, capsys, mod, argv):
    """No CUDA device: exit non-zero with the reason, no result line, and
    no fall-back to the CPU or to --quick."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)
    assert capsys.readouterr().out == ""


def _tiny():
    return TB.dense_stress_config().replace(n_particles=32, maxFeatures=32,
                                            maxMeasurements=16)


def test_runner_window_on_cpu():
    """Warm-up, snapshot, then windows that each replay the same steps
    from the snapshot: equal final states, finite positive ms per step."""
    runner = TB.StressRunner(_tiny(), "cpu", n_steps=7, warmup=3)
    ms = runner.window()
    first = runner.state
    assert np.isfinite(ms) and ms > 0
    assert runner.window() > 0
    assert first is not runner.state
    for a, b in zip(dataclasses.astuple(first),
                    dataclasses.astuple(runner.state)):
        if torch.is_tensor(a):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(first.map_static.w.sum()) > 0


def test_bench_many_on_cpu():
    """The three modes of main, one window each, on the CPU."""
    cfg = _tiny()
    ms = TB.bench_many([cfg, cfg.replace(mergeMode=1),
                        cfg.replace(mergeMode=1, selectTopK=2)], "cpu",
                       n_steps=5, warmup=3, n_windows=1)
    assert len(ms) == 3 and all(np.isfinite(m) and m > 0 for m in ms)


def test_cpu_reference_on_a_key_miss(tmp_path, monkeypatch):
    """The --quick shape misses the pinned key: the CPU reference runs
    (reference_cpu.run, 32 particles, 1 + 4 steps) and writes nothing, in
    results/ or in the working directory."""
    monkeypatch.chdir(tmp_path)
    quick = TB.dense_stress_config().replace(n_particles=512,
                                             maxFeatures=128)
    assert TB.anchor_key(quick.replace(n_particles=32), 4) != PINNED_KEY
    results = sorted((p.name, p.stat().st_mtime_ns)
                     for p in (ROOT / "results").iterdir())
    ms, p, how = TB.bench_cpu_reference(quick)
    assert how == "measured" and p == 32 and np.isfinite(ms) and ms > 0
    assert sorted((p.name, p.stat().st_mtime_ns)
                  for p in (ROOT / "results").iterdir()) == results
    assert list(tmp_path.iterdir()) == []


def test_power_limit_parse():
    assert TB.power_limit_w("NVIDIA H100 80GB HBM3, 700.00 W") == 700.0


def test_stage_profile_on_cpu():
    """Every stage of the profile at a tiny shape on the CPU, named as
    scripts/tpu_profile.py names them (less its XLA and scalar-out
    stages), each a finite time."""
    seen = []
    rec = TP.profile_stages("cpu", (("tiny", (16, 16, 8)),),
                            disparity=(8, 8, 8), reps=1, log=lambda s: None,
                            after=seen.append)
    assert seen == list(rec)
    assert list(rec) == [
        "tiny: kalman_preupdate",
        "tiny: phd_update_static (kernel)",
        "tiny: phd_update_static (kernel, index sel)",
        "tiny: slam_step static (kernel)",
        "tiny: slam_step static (kernel, index sel)",
        "tiny: slam_step static (kernel, fast merge)",
        "tiny: slam_step static (kernel, fast merge, k2)",
        "tiny: slam_step static (kernel, fast merge, index sel)",
        "tiny: slam_step CPHD (P=16)",
        "tiny: slam_step mixed (P=16)",
        "disparity_step (P=8, F=8)"]
    assert all(np.isfinite(v) and v > 0 for v in rec.values())


def test_make_problem_shapes():
    """make_problem's draws: three quarters of the slots live, the last 3
    measurements padding, covariances positive definite."""
    cfg = TB.dense_stress_config()
    pose, gm, z = TP.make_problem(np.random.default_rng(1), cfg, 8, 16, 10,
                                  "cpu")
    assert pose.shape == (8, 6) and gm.w.shape == (8, 16)
    assert (gm.w[:, :12] > 0).all() and (gm.w[:, 12:] == 0).all()
    assert (gm.c00 * gm.c11 - gm.c01 ** 2 > 0).all()
    assert z.count == 7 and z.rb.shape == (10, 2)

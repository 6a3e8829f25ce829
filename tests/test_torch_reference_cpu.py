"""The port's copies of the NumPy CPU reference
(``phdslam_tpu_torch/reference_cpu.py``, ``reference_cpu_disparity.py``)
against the JAX package's: ``run`` of each copy on the same config (read
by each package's own ``load_config``), stream and seed returns the same
float64 poses bit for bit, and every particle ends with the same map. The
Ackerman runs: the stress stream of ``bench.py`` (chip_smoke.py's copy) at
8 particles over 4 steps (static, CPHD and mixed filters); the disparity
run: the first steps of ``data/disparity_synth/`` at 8 particles."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from phdslam_tpu import config as JC
from phdslam_tpu import reference_cpu as JR
from phdslam_tpu import reference_cpu_disparity as JRD
from phdslam_tpu.io.loaders import load_measurements
from phdslam_tpu_torch import config as TC
from phdslam_tpu_torch import reference_cpu as TR
from phdslam_tpu_torch import reference_cpu_disparity as TRD

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import dense_overrides, make_stress_inputs  # noqa: E402

torch.set_num_threads(1)

MODES = {"static": {}, "cphd": dict(filterType=1, maxCardinality=31),
         "mixed": dict(featureModel=2)}


def _stress_run(mod, cfg_mod, mode, steps=5):
    cfg = dense_overrides(cfg_mod.load_config("cfg/ackerman_synth.cfg")
                          .replace(n_particles=8, maxFeatures=16,
                                   maxMeasurements=12, **MODES[mode]))
    rb, valid, controls = make_stress_inputs(cfg, steps)
    meas = [rb[t][valid[t]] for t in range(steps)]
    ends = []
    fields = ("w", "mean", "cov", "cn", "wd", "mean4")
    poses = mod.run(cfg, controls[1:], meas, seed=3,
                    callback=lambda t, slam: ends.append(
                        [(p.log_weight,) + tuple(
                            None if getattr(p, f) is None
                            else getattr(p, f).copy() for f in fields)
                         for p in slam.particles]))
    return poses, ends[-1]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_reference_cpu_run_matches_jax(mode):
    want, want_end = _stress_run(JR, JC, mode)
    got, got_end = _stress_run(TR, TC, mode)
    assert got.dtype == np.float64 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    assert len(got_end) == len(want_end)
    for g, w in zip(got_end, want_end):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    assert sum(len(p[1]) for p in got_end) > 0     # the maps hold features


def test_reference_cpu_disparity_run_matches_jax():
    sets = load_measurements("data/disparity_synth/measurements.txt")[:4]
    meas = [np.stack([s.ranges, s.bearings], axis=1) for s in sets]
    runs = []
    for mod, cfg_mod in ((JRD, JC), (TRD, TC)):
        cfg = cfg_mod.load_config("cfg/disparity_synth.cfg").replace(
            n_particles=8)
        ends = []
        poses = mod.run(cfg, meas, seed=1, callback=lambda t, ps: ends.append(
            [(p.log_weight, p.w.copy(), p.clouds.copy()) for p in ps]))
        runs.append((poses, ends[-1]))
    (want, want_end), (got, got_end) = runs
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_end, want_end):
        assert g[0] == w[0]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
    assert sum(len(p[1]) for p in got_end) > 0

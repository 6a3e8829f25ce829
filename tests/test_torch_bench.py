"""The dense-stress config and stream of the JAX package's ``bench.py``,
as ``chip_smoke.py`` copies them for its dense phases (phase 7 runs
``stress_cfg(DENSE)`` on ``make_stress_inputs``): the same headline config
field for field, the same stress stream, and ``bench.py``'s contract
checks (``tests/test_bench_contract.py``) on the copy."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench as JB  # noqa: E402
import chip_smoke as C  # noqa: E402


def test_dense_stress_config_matches_jax():
    assert dataclasses.asdict(C.stress_cfg(C.DENSE)) == \
        dataclasses.asdict(JB.dense_stress_config())


@pytest.mark.parametrize("seed", [0, 3])
def test_make_stress_inputs_matches_jax(seed):
    cfg = C.stress_cfg(C.DENSE)
    for a, b in zip(C.make_stress_inputs(cfg, 19, seed),
                    JB.make_stress_inputs(cfg, 19, seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# bench.py's contract (tests/test_bench_contract.py) on the copy

def test_headline_config_matches_shipped_defaults():
    from phdslam_tpu_torch.config import load_config
    shipped = load_config("cfg/ackerman_synth.cfg")
    stress = C.stress_cfg(C.DENSE)
    drift = {
        f.name: (getattr(shipped, f.name), getattr(stress, f.name))
        for f in dataclasses.fields(shipped)
        if f.name not in JB.STRESS_OVERRIDES
        and getattr(shipped, f.name) != getattr(stress, f.name)
    }
    assert not drift, (
        "dense-stress config drifted from shipped defaults on "
        f"non-shape fields: {drift}")


def test_stress_overrides_are_shape_only():
    """The fields the copy changes in the port's shipped cfg are among
    bench.py's overrides, and none is filter semantics."""
    from phdslam_tpu_torch.config import load_config
    shipped = load_config("cfg/ackerman_synth.cfg")
    stress = C.stress_cfg(C.DENSE)
    changed = {f.name for f in dataclasses.fields(shipped)
               if getattr(shipped, f.name) != getattr(stress, f.name)}
    semantic = {"mergeMode", "selectTopK", "usePallas", "mergeCompactK",
                "minSeparation", "minFeatureWeight", "mergeMinWeight",
                "filterType", "motionType", "mapType", "weightingScheme"}
    assert changed and changed <= set(JB.STRESS_OVERRIDES)
    assert not semantic & changed

"""The comparison that decides ``correct``: a sound run passes, the
control (the reference at TF32's precision in the program's place) and
each fault planted under the timed path fail. On the CPU at small sizes,
where the port runs its kernels' plain versions; the card test runs the
control at a cell's own size."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import harness_faults  # noqa: E402

from benchmark import harness, judge, run, scene  # noqa: E402


def small(name, per_rank=32, F=16, M=16):
    cell = harness.load_cell(name)
    cell.cfg.update(n_particles=per_rank * cell.chips, max_features=F,
                    max_measurements=M)
    return cell


def cpu_run(cell, seed, hook=None, seconds=0.6, with_control=False):
    res, _ = run.run_cell(cell, seed, seconds, False, "cpu", hook,
                          with_control)
    return res


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_sound_run_reads_nought_on_the_cpu(seed):
    """On the CPU the reference and the port's plain path compute the
    same bits."""
    res = cpu_run(small("dense8k.clutter40"), seed)
    assert res["correct"]
    assert all(v["value"] == 0.0 for v in res["checks"].values())
    assert len(res["judged"][0]) >= 3


def test_control_fails():
    """The reference at TF32's precision, in the program's place."""
    for seed in (5, 6, 7):
        res = cpu_run(small("dense8k.clutter40"), seed, with_control=True)
        ok, _ = judge.verdict(res["readings"]["control"],
                              harness.load_cell("dense8k.clutter40").limits)
        assert res["correct"] and not ok


def test_a_full_set_is_judged():
    """The latest step whose set filled max_measurements is judged."""
    cell = small("dense8k.clutter40")
    res = cpu_run(cell, 21)
    steps = res["judged"][0]
    stream = scene.make_stream(
        cell.traffic, int(harness.seed_seq(21, 0).generate_state(1)[0]),
        harness.n_steps_for(0.6), 16)
    full = [t for t in range(max(steps) + 1) if stream.count[t] == 16]
    assert full and max(full) in steps


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "altered_answer"])
def test_faults_fail_one_rank(fault):
    res = cpu_run(small("dense8k.clutter40"), 11,
                  getattr(harness_faults, fault))
    assert not res["correct"]


@pytest.mark.parametrize("fault", ["no_exchange", "unchanged"])
def test_faults_fail_over_ranks(fault):
    cell = small("wide65k.clutter20")
    cell.chips = 2
    res = cpu_run(cell, 12, getattr(harness_faults, fault))
    assert not res["correct"]


def test_sound_run_over_ranks():
    cell = small("wide65k.clutter20")
    cell.chips = 2
    res = cpu_run(cell, 13)
    assert res["correct"]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_control_fails_at_cell_size(gpu):
    """The program passes and the control fails at dense8k.clutter40's own
    size, on three seeds."""
    cell = harness.load_cell("dense8k.clutter40")
    for seed in (101, 102, 2**31 + 103):
        res = harness.run_rank(harness.load_cell("dense8k.clutter40"), seed,
                               1.0, False, gpu, time.monotonic(),
                               with_control=True)
        assert res["correct"]
        assert not judge.verdict(res["readings"]["control"],
                                 cell.limits)[0]

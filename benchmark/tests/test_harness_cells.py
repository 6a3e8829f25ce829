"""The harness's data and arithmetic on the CPU: cells, configurations,
traffic and metrics found by name; the copied generator; the 95th
percentile over all steps; idle and roofline shares on synthetic traces;
the last line's schema."""

from __future__ import annotations

import io
import json
import re
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import counts as C  # noqa: E402
from benchmark import harness, run, scene  # noqa: E402
from benchmark import trace as T  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(w):
    cell = harness.load_cell(w["name"])
    assert cell.chips == w["chips"]
    names = {e["name"] for e in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert names <= {"step_ms", "step_ms_p95", "setup_s"}
    assert cell.per_layer
    assert {m["moves"] for m in cell.per_layer} <= names
    for m in cell.per_layer:
        assert callable(harness.load_metric(m["name"]))
    assert set(cell.limits) == set(
        __import__("benchmark.judge").judge.NAMES)


def test_names_units_and_bounds():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    moves = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in moves for m in BENCH["per_layer"])
    for c in BENCH["configs"]:
        f = json.loads((REPO / c["file"]).read_text())
        assert f["reduced"] == c["reduced"]


def test_generator_is_repeatable_and_matches_the_port():
    t = json.loads((REPO / "benchmark/traffic/landmarks.clutter20.json")
                   .read_text())
    a = scene.make_stream(t, 2**31 + 9, 50, 64)
    b = scene.make_stream(t, 2**31 + 9, 50, 64)
    assert np.array_equal(a.rb, b.rb) and np.array_equal(a.controls,
                                                         b.controls)
    assert not np.array_equal(scene.make_stream(t, 1, 50, 64).rb, a.rb)
    from phdslam_tpu_torch import simdata
    mine = scene.make_scenario(np.random.default_rng(4), n_steps=40)
    port = simdata.make_scenario(np.random.default_rng(4), n_steps=40)
    assert np.array_equal(mine.traj, port.traj)
    assert np.array_equal(mine.landmarks, port.landmarks)
    for k in range(5):
        za = scene.generate_measurements(np.random.default_rng(k), mine,
                                         mine.traj[k])
        zb = simdata.generate_measurements(np.random.default_rng(k), port,
                                           port.traj[k])
        assert np.array_equal(za, zb)


def test_stream_cuts_as_the_loaders_do():
    t = json.loads((REPO / "benchmark/traffic/landmarks.clutter40.json")
                   .read_text())
    st = scene.make_stream(t, 0, 60, 8)
    assert st.n_cut > 0 and st.count.max() == 8
    assert (st.valid.sum(1) == st.count).all()


def test_p95_over_all_steps():
    lat = [1.0] * 90 + [10.0] * 10
    assert harness.p95(lat) == pytest.approx(10.0)
    assert harness.p95(list(range(1, 101))) == pytest.approx(95.05)


def synthetic_trace():
    tr = T.Trace(window=(0.0, 1000.0))
    tr.device = [("void select_kernel<16, false>(x)", 100.0, 200.0),
                 ("void merge_kernel<0>(x)", 200.0, 400.0),
                 ("vectorized_elementwise_kernel", 150.0, 250.0),
                 ("ncclDevKernel_AllGather", 500.0, 550.0),
                 ("Memcpy HtoD (Pageable -> Device)", 600.0, 610.0),
                 ("merge4_kernel", 700.0, 710.0)]
    tr.host = [("upload", 0.0, 100.0), ("dispatch", 400.0, 700.0),
               ("pose_read", 710.0, 1000.0)]
    return tr


def test_idle_and_roofline_shares():
    tr = synthetic_trace()
    assert T.busy_us(tr) == pytest.approx(300 + 50 + 10 + 10)
    gaps = T.idle_gaps(tr)
    assert gaps[0] == ("pose_read", pytest.approx(290.0))
    assert ("upload", pytest.approx(100.0)) in gaps
    assert T.glue_us(tr) == pytest.approx(100.0 + 10.0)
    ctx = dict(trace=tr, steps=2, wall_ms=0.5, select_bound_ms=0.05,
               merge_bound_ms=0.02, traffic=None,
               window_steps=10, world=1, dispatch_ms=0.1)
    read = harness.load_metric
    assert read("select_roofline")(ctx) == pytest.approx(50.0)
    assert read("merge_roofline")(ctx) == pytest.approx(10.0)
    assert read("device.idle_pct")(ctx) == pytest.approx(
        100 * (1 - 0.37 / 2 / 0.5))
    assert read("glue.device_ms")(ctx) == pytest.approx(0.055)
    assert read("mesh.nccl_device_ms")(ctx) == pytest.approx(0.025)
    assert read("mesh.mb_per_step")(ctx) is None
    ctx["traffic"] = {"gather_rows step": dict(received=3e6)}
    assert read("mesh.mb_per_step")(ctx) == pytest.approx(0.3)
    empty = dict(ctx, trace=T.Trace(window=(0.0, 10.0)))
    assert read("select_roofline")(empty) is None
    assert read("merge_roofline")(empty) is None


def test_bounds_count_the_launch():
    assert C.bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert C.bound_ms(0, 67e9) == pytest.approx(1.0)
    assert C.pool_size(512, 64, 8) == 1088
    assert C.merge_bytes(2, 10, 5) == 4 * 6 * 2 * 15


@pytest.mark.parametrize("traced", [0, 1])
def test_last_line_schema(traced):
    cell = harness.load_cell("dense8k.clutter40")
    cell.cfg.update(n_particles=32, max_features=16, max_measurements=16)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        res, dev = run.run_cell(cell, 77, 0.4, bool(traced), "cpu")
        run.emit(cell, 77, bool(traced), res, dev)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    assert line["correct"] is True and line["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert len(line["breakdown"]["idle_gaps"]) <= 10
        assert "host.dispatch_ms" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"step_ms", "step_ms_p95",
                                        "setup_s"}
    tail = err.getvalue().strip().splitlines()[-6:]
    assert all(t.startswith("check ") for t in tail)

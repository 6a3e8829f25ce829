"""The port's spans (``phdslam_tpu_torch/spans.py``) and the benchmark's
stage metrics that read them.

On the CPU: off (the default) a step records nothing and makes no CUDA
event; under ``torch.profiler`` (CPU activity) or ``enable(True)`` every
span of the static GM-PHD step is recorded once a step, under its parent,
with the step's number, and lies on the profiler's timeline; the other
filters' branches get only ``update``; a step's outputs are the same bits
with the spans on and off; device times fold into parents (fake events);
the stage readers find nothing on a CPU record and divide by the steps on
a synthetic one.

On the card (marked ``cuda``, skipped without a GPU; run without the
suite's JAX conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_spans.py

a spanned dense step runs under ``torch.cuda.set_sync_debug_mode("error")``,
every stage has device time and the stages sum to the root within 10 %.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from phdslam_tpu_torch import load_config, simdata, spans
from phdslam_tpu_torch.filter.state import Measurements, SlamState
from phdslam_tpu_torch.filter.step import draw_noise, slam_step

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

ROOT = spans.ROOT
STAGES = ("predict", "preupdate", "select", "normalizers", "pool", "merge",
          "estimate", "resample")
PARENT = dict(predict=ROOT, update=ROOT, estimate=ROOT, resample=ROOT,
              preupdate="update", select="update", normalizers="update",
              pool="update", merge="update")
TINY = dict(n_particles=8, maxFeatures=16, maxMeasurements=8,
            birthWeight=0.02, stdEncoder=0.05, stdAlpha=0.005, y0=0.0)
#: cfg file and overrides of each filter branch
BRANCHES = {
    "static": ("cfg/ackerman_synth.cfg", {}),
    "static_by_index": ("cfg/ackerman_synth.cfg", dict(selectByIndex=1)),
    "static_fast_merge": ("cfg/ackerman_synth.cfg", dict(mergeMode=1)),
    "static_weighting2": ("cfg/ackerman_synth.cfg",
                          dict(particleWeighting=2)),
    "cphd": ("cfg/ackerman_synth.cfg", dict(filterType=1)),
    "fastslam": ("cfg/ackerman_synth.cfg", dict(filterType=2)),
    "mixed": ("cfg/mixed_synth.cfg", dict(clutterRate=2.0)),
}


@pytest.fixture(autouse=True)
def fresh_record():
    spans.enable(False)
    spans.reset()
    yield
    spans.enable(False)
    spans.reset()


@pytest.fixture(scope="module")
def run():
    sc = simdata.make_scenario(np.random.default_rng(11), n_landmarks=12,
                               n_steps=6, clutter_rate=2.0)
    return simdata.generate_run(np.random.default_rng(12), sc,
                                control_noise=(0.05, 0.005))


def _cfg(branch="static", **over):
    path, kw = BRANCHES[branch]
    return load_config(path).replace(**{**TINY, **kw, **over})


def _z(meas_t, M, device=None):
    rb = np.zeros((M, 2), np.float32)
    valid = np.zeros((M,), bool)
    k = min(len(meas_t), M)
    rb[:k] = meas_t[:k]
    valid[:k] = True
    return Measurements.from_numpy(rb, np.zeros((M,), np.int32), valid,
                                   device)


def _tensors(tree):
    """Every tensor of a state (its mixtures' channels included)."""
    import dataclasses
    out = []
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if dataclasses.is_dataclass(v):
            out += _tensors(v)
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def _outputs(cfg, run, n=3):
    controls, meas = run
    gen = torch.Generator().manual_seed(5)
    state = SlamState.create(cfg)
    z_prev, out = None, []
    for t in range(n):
        z = _z(meas[t], cfg.maxMeasurements)
        state, aux = slam_step(
            state, (float(controls[t, 0]), float(controls[t, 1])), z, 1.0,
            t > 0, cfg, generator=gen, z_prev=z_prev)
        z_prev = z
        out.append(_tensors(state) + list(aux))
    return out


class _CountingEvent:
    made = 0

    def __init__(self, *a, **kw):
        type(self).made += 1


def test_spans_off_record_nothing_and_make_no_event(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _CountingEvent)
    assert not torch.autograd._profiler_enabled()
    assert spans.span("predict") is spans.span(ROOT, "cpu")
    _outputs(_cfg(), run)
    assert spans.summary() == {}
    assert _CountingEvent.made == 0
    assert not spans._pending and not spans._stack


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_profiler_records_every_span_once_a_step(run, branch):
    cfg = _cfg(branch)
    n = 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _outputs(cfg, run, n)
    rec = spans.summary()
    static = branch.startswith("static")
    names = {ROOT, "predict", "update", "estimate", "resample"}
    if static:
        names |= set(STAGES)
    assert set(rec) == names
    on_timeline = {e.name for e in prof.events()}
    for name in names:
        r = rec[name]
        per_step = 2 if (name == "normalizers"
                         and cfg.particleWeighting == 2) else 1
        assert r["calls"] == per_step * n, name
        assert r["steps"] == n and r["step"] == n, name
        assert r["parents"] == ((PARENT[name],) if name != ROOT else ()), name
        assert 0.0 <= r["host_self_ms"] <= r["host_ms"], name
        assert r["device_ms"] is None and r["device_self_ms"] is None
        assert name in on_timeline, name
    children = sum(rec[k]["host_ms"] for k in names
                   if rec[k]["parents"] == (ROOT,))
    assert children <= rec[ROOT]["host_ms"]
    assert rec[ROOT]["host_self_ms"] == pytest.approx(
        rec[ROOT]["host_ms"] - children, abs=1e-6)


def test_enable_records_without_the_profiler(run):
    spans.enable(True)
    assert not torch.autograd._profiler_enabled()
    _outputs(_cfg(), run, 2)
    rec = spans.summary()
    assert {rec[k]["calls"] for k in (ROOT, "update", *STAGES)} == {2}
    spans.enable(False)
    _outputs(_cfg(), run, 1)
    assert spans.summary()[ROOT]["calls"] == 2
    spans.reset()
    assert spans.summary() == {}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_outputs_are_the_same_bits_with_spans_on_and_off(run, branch):
    cfg = _cfg(branch)
    off = _outputs(cfg, run)
    spans.enable(True)
    on = _outputs(cfg, run)
    assert spans.summary()[ROOT]["calls"] == 3
    for a_step, b_step in zip(off, on):
        assert len(a_step) == len(b_step)
        for a, b in zip(a_step, b_step):
            assert torch.equal(a, b)


class _FakeEvent:
    """A recorded event at a given device time (ms); done once
    ``done`` is set."""

    def __init__(self, t):
        self.t = t
        self.done = True

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, other):
        assert self.done and other.done
        return other.t - self.t


def test_device_ms_fold_into_parents_and_wait_for_their_events(
        monkeypatch):
    # device clock at each event record: root 0, a 1..4, b 4..9, root 10
    clock = iter([0.0, 1.0, 4.0, 4.0, 9.0, 10.0, 20.0, 22.0])
    made = []

    def fake_event(device, stream):
        assert stream == "stream"
        made.append(_FakeEvent(next(clock)))
        return made[-1]

    monkeypatch.setattr(spans, "_event", fake_event)
    monkeypatch.setattr(spans, "_stream", lambda device: "stream")
    monkeypatch.setattr(spans, "_capturing", lambda: False)
    spans.enable(True)
    with spans.span(ROOT, "cuda"):
        with spans.span("a"):
            pass
        with spans.span("b"):
            pass
        made[-1].done = False           # b's end event is not done yet
        assert [s.name for s in spans._pending] == ["a", "b"]
    # the root's close resolved a, then stopped at b
    assert [s.name for s in spans._pending] == ["b", ROOT]
    rec = spans.summary()
    assert not spans._pending
    assert rec[ROOT]["device_ms"] == 10.0
    assert rec[ROOT]["device_self_ms"] == 10.0 - 3.0 - 5.0
    assert (rec["a"]["device_ms"], rec["b"]["device_ms"]) == (3.0, 5.0)
    assert rec["a"]["device_self_ms"] == 3.0
    # a span with no root device records host time only
    with spans.span("c"):
        pass
    assert spans.summary()["c"]["device_ms"] is None
    assert len(made) == 6
    # while the stream captures a graph the spans do nothing
    monkeypatch.setattr(spans, "_capturing", lambda: True)
    with spans.span(ROOT, "cuda"):
        with spans.span("a"):
            pass
    assert spans.summary()[ROOT]["calls"] == 1 and len(made) == 6


def _metric(name):
    from benchmark import harness
    return harness.load_metric(name)


def test_the_benchmark_lists_every_stage_metric():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]]
    for s in STAGES:
        m = per_layer[f"stage.{s}_ms"]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "ms", "lower", "program_span", "step_ms")
        assert m["workloads"] == cells


@pytest.mark.parametrize("stage", STAGES)
def test_stage_readers(run, stage, monkeypatch):
    read = _metric(f"stage.{stage}_ms")
    assert read({}) is None                   # nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        _outputs(_cfg(), run, 2)
    assert spans.summary()[stage]["calls"] >= 2
    assert read({}) is None                   # a CPU record: no device time
    synthetic = {ROOT: dict(calls=4, device_ms=40.0),
                 stage: dict(calls=4, device_ms=6.0)}
    monkeypatch.setattr(spans, "summary", lambda: synthetic)
    assert read({}) == pytest.approx(1.5)
    del synthetic[stage]
    assert read({}) is None


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the spans' device times are CUDA "
                    "events)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_spanned_dense_step_on_the_card(cuda_dev):
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=8192, maxFeatures=256, maxMeasurements=64,
        birthWeight=1e-3, y0=0.0, clutterRate=20.0)
    sc = simdata.make_scenario(np.random.default_rng(3), n_steps=12,
                               clutter_rate=20.0)
    controls, meas = simdata.generate_run(np.random.default_rng(4), sc,
                                          control_noise=(0.05, 0.005))
    gen = torch.Generator(device=cuda_dev).manual_seed(1)
    state = SlamState.create(cfg, cuda_dev)
    zs = [_z(m, cfg.maxMeasurements, cuda_dev) for m in meas[:12]]
    noises = [draw_noise(cfg, cfg.n_particles, cuda_dev, gen)
              for _ in zs]

    def step(t, state):
        return slam_step(state, (float(controls[t, 0]),
                                 float(controls[t, 1])), zs[t], 1.0, t > 0,
                         cfg, noise=noises[t],
                         z_prev=zs[t - 1] if t else None)[0]

    for t in range(6):                        # build and warm the kernels
        state = step(t, state)
    torch.cuda.synchronize()
    spans.enable(True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(6, 12):
            state = step(t, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rec = spans.summary()
    root = rec[ROOT]["device_ms"]
    assert rec[ROOT]["calls"] == 6 and root > 0
    for s in STAGES:
        assert rec[s]["calls"] == 6 and rec[s]["device_ms"] > 0, s
    stages = sum(rec[s]["device_ms"] for s in STAGES)
    assert stages <= root * (1 + 1e-3)
    assert stages >= 0.9 * root, (stages, root)

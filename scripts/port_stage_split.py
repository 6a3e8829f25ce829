"""The port's static GM-PHD step split by its spans
(``phdslam_tpu_torch/spans.py``), at the benchmark's cells, on the card.

    python3 scripts/port_stage_split.py [--cells dense8k.clutter40 ...] \\
        [--seed 7] [--window 100] [--rounds 6] \\
        [--out build/stage_split.json]

What it prints, one JSON line per part, and writes to --out:

- ``cost``: the spans' cost on the host. Off: ns a ``with span(...)``
  block and ns a read of the profiler's flag, over a million calls each.
  On (``enable(True)``, no profiler, on the card): ns a root span and a
  child span, and of their parts: a ``record_function`` block (opened
  only under a profiler), a timing event's record, a
  ``current_stream`` call (once a root).
- per cell (the benchmark's scene, program and online step:
  ``benchmark/harness.py``'s ``Rank``): after the warm-up, --rounds
  rounds of two --window-step windows, spans off and on
  (``enable(True)``, no profiler; the first side alternates), ms a step
  of each (the step ends with its pose on the host); the spans' host and
  device ms a step of each span over the on windows; then the
  benchmark's 16 profiled steps (``Rank.profile``) with the spans' record
  of them, the trace's ``glue.device_ms`` and busy ms a step, and the
  device ops whose names are a span's (none expected: annotations are not
  device work).

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CELLS = ("dense8k.clutter40", "wide65k.clutter20")
NAMES = ("slam_step", "predict", "update", "preupdate", "select",
         "normalizers", "pool", "merge", "estimate", "resample")


def off_cost(n=1_000_000):
    """(ns a span block, ns a flag read) with the spans off."""
    import torch

    from phdslam_tpu_torch import spans
    spans.enable(False)
    span, flag = spans.span, torch.autograd._profiler_enabled
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("predict"):
            pass
    t1 = time.perf_counter_ns()
    for _ in range(n):
        flag()
    t2 = time.perf_counter_ns()
    for _ in range(n):
        pass
    t3 = time.perf_counter_ns()
    return dict(span_ns=(t1 - t0) / n, flag_ns=(t2 - t1) / n,
                empty_loop_ns=(t3 - t2) / n)


def on_cost(device, n=20_000):
    """ns a span and its parts with the spans on, no profiler."""
    import torch

    from phdslam_tpu_torch import spans
    ev = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream(device)

    def each(f):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            f()
        return (time.perf_counter_ns() - t0) / n

    def fn():
        with torch.profiler.record_function("predict"):
            pass

    def root():
        with spans.span(spans.ROOT, device):
            pass

    def child():
        with spans.span("predict"):
            pass

    spans.enable(True)
    try:
        out = dict(record_function_ns=each(fn),
                   event_record_ns=each(lambda: ev.record(stream)),
                   current_stream_ns=each(
                       lambda: torch.cuda.current_stream(device)),
                   root_span_ns=each(root))
        with spans.span(spans.ROOT, device):
            out["child_span_ns"] = each(child)
    finally:
        spans.enable(False)
        spans.reset()
    torch.cuda.synchronize(device)
    return out


def per_step(record, steps):
    return {k: {f: (v / steps if isinstance(v, float) else v)
                for f, v in record[k].items()
                if f in ("calls", "host_ms", "host_self_ms", "device_ms",
                         "device_self_ms")}
            for k in NAMES if k in record}


def run_cell(name, seed, window, rounds, device):
    import torch

    from benchmark import harness
    from benchmark import trace as T
    from phdslam_tpu_torch import spans
    cell = harness.load_cell(name)
    steps = rounds * 2 * window + harness.PROFILED + 1
    rk = harness.Rank(cell, seed, steps / 1000.0, device)
    rk.warm_up()
    off, on = [], []
    spans.reset()
    for r in range(rounds):
        sides = ((False, off), (True, on))
        for enabled, out in sides if r % 2 == 0 else sides[::-1]:
            spans.enable(enabled)
            t0 = time.perf_counter()
            for _ in range(window):
                rk.one_step()
            out.append((time.perf_counter() - t0) * 1e3 / window)
    spans.enable(False)
    split = per_step(spans.summary(), rounds * window)
    spans.reset()
    tr, _ = rk.profile()
    traced = per_step(spans.summary(), harness.PROFILED)
    span_ops = [n for n, _ in T.top_ops(tr, 10_000) if n in NAMES]
    res = dict(
        cell=name, seed=seed, window=window, rounds=rounds,
        ms_off=off, ms_on=on, ms_off_median=statistics.median(off),
        ms_on_median=statistics.median(on),
        on_cost_ms=statistics.median(on) - statistics.median(off),
        enabled=split, profiled=traced,
        glue_device_ms=T.glue_us(tr) / 1e3 / harness.PROFILED,
        busy_ms=T.busy_us(tr) / 1e3 / harness.PROFILED,
        device_ops_named_as_spans=span_ops,
        peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    del rk
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--window", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out", default="build/stage_split.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    torch.set_num_threads(1)
    from benchmark import program
    program.load_kernels(device)
    out = dict(device=torch.cuda.get_device_name(device),
               torch=torch.__version__,
               cost=dict(off_cost(), **on_cost(device)), cells=[])
    print(json.dumps(dict(cost=out["cost"])), flush=True)
    for name in args.cells:
        res = run_cell(name, args.seed, args.window, args.rounds, device)
        out["cells"].append(res)
        print(json.dumps(res), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

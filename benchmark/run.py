"""Run one cell of the benchmark of phdslam_tpu_torch.

    python3 benchmark/run.py --workload NAME --seed N --seconds S \
        --trace 0|1

From the root of a checkout. Prints one JSON line last on standard output
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``; with
``--trace 1`` also ``breakdown``; last, ``checks``: each number the
comparison judged with its limit), and the same numbers as the last lines
of standard error. Exits non-zero, printing no result, without CUDA or
with fewer GPUs than the cell asks for. A cell on W GPUs runs W processes
(NCCL, one GPU each, a rendezvous on a free localhost port).
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
# every cache a library might write stays at a fixed path in the checkout
CACHE = REPO / "build" / "benchmark_cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, cell, seed, seconds, traced, t_start,
               queue, device_type, hook, with_control):
    """One rank of a cell on W devices; rank 0 puts the result on queue."""
    import torch
    import torch.distributed as dist

    from benchmark import harness, program
    if hook is not None:
        hook()
    torch.set_num_threads(1)
    device = torch.device(f"cuda:{rank}" if device_type == "cuda"
                          else "cpu")
    mesh = program.make_mesh(device, rank, world,
                             f"tcp://127.0.0.1:{port}")
    ctl = dist.new_group(backend="gloo")
    try:
        res = harness.run_rank(cell, seed, seconds, traced, device, t_start,
                               mesh, ctl, with_control)
        dist.barrier(group=ctl)
    finally:
        mesh.close()
    if rank == 0:
        queue.put(res)


def run_cell(cell, seed, seconds, traced, device_type="cuda", hook=None,
             with_control=False):
    """The cell's result dict, from this process (one device) or from W
    spawned ranks; a rank that fails ends the others."""
    import multiprocessing as mp
    import queue as queues

    import torch

    from benchmark import harness
    device = torch.device("cuda:0" if device_type == "cuda" else "cpu")
    if cell.chips == 1:
        if hook is not None:
            hook()
        torch.set_num_threads(1)
        return harness.run_rank(cell, seed, seconds, traced, device,
                                T_START, with_control=with_control), device
    ctx = mp.get_context("spawn")
    box = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        r, cell.chips, port, cell, seed, seconds, traced, T_START, box,
        device_type, hook, with_control)) for r in range(cell.chips)]
    for p in procs:
        p.start()
    res = None
    try:
        while res is None:
            try:
                res = box.get(timeout=1.0)
            except queues.Empty:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes) \
                        or all(c is not None for c in codes):
                    break
    finally:
        if res is None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad or res is None:
        raise SystemExit(f"a rank failed (exit codes "
                         f"{[p.exitcode for p in procs]})")
    return res, device


def main(argv=None):
    """Run on the GPUs and print; returns the result line."""
    args = parse(argv)
    import torch

    from benchmark import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "False); the benchmark runs only on GPUs")
    if torch.cuda.device_count() < cell.chips:
        raise SystemExit(f"{args.workload} needs {cell.chips} GPUs, "
                         f"{torch.cuda.device_count()} are visible")
    res, device = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    return emit(cell, args.seed, bool(args.trace), res, device)


def emit(cell, seed, traced, res, device):
    """Print a run's summary and checks on standard error and its result
    line last on standard output; returns the line."""
    from benchmark import harness
    bad = harness.banned_modules()
    if bad:
        raise SystemExit(f"modules of {', '.join(bad)} are loaded")
    line = harness.result_line(cell, res, traced, device)
    build = res["build"]
    print(f"{cell.name} seed {seed}: {res['steps']} steps in "
          f"{res['window_s']:.3f} s, set-up {res['setup_s']:.3f} s (kernel "
          f"build {'ran' if build.get('built') else 'reused'}, "
          f"{build.get('seconds', 0.0):.1f} s); {res['cut']} steps cut to "
          f"max_measurements; judged steps {res['judged'][0]}",
          file=sys.stderr)
    print(harness.checks_text(res["checks"]), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()

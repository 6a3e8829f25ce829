"""The readings the check's limits are set from, on the GPU.

    python3 benchmark/calibrate.py --workload NAME --seconds S \
        --seeds N1 N2 ... [--out FILE]

For each seed: a short window of the cell at its own size and load, then
the comparison's numbers twice on the same judged steps: the program's
(the lower readings) and the control's, the reference computed at TF32's
precision in the program's place (the upper readings). One JSON line per
seed, and the largest program reading and the smallest control reading
of each number at the end. The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness, judge, run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = []
    for seed in args.seeds:
        cell = harness.load_cell(args.workload)
        t0 = time.perf_counter()
        res, _ = run.run_cell(cell, seed, args.seconds, False,
                              with_control=True)
        row = dict(workload=args.workload, seed=seed, steps=res["steps"],
                   step_ms=res["step_ms"], judged=res["judged"][0],
                   s=time.perf_counter() - t0, **res["readings"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = dict(
        workload=args.workload, seeds=args.seeds,
        program_max={k: max(r["program"][k] for r in rows)
                     for k in judge.NAMES},
        control_min={k: min(r["control"][k] for r in rows)
                     for k in judge.NAMES})
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows + [summary]:
                f.write(json.dumps(r) + "\n")
    return rows, summary


if __name__ == "__main__":
    main()

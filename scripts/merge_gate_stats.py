"""How the merge kernel's gated chain engages on the pools the benchmark's
cells really merge, on the card.

    python3 scripts/merge_gate_stats.py [--cells dense8k.clutter40 ...] \\
        [--seed 7] [--steps 600] [--every 50] \\
        [--out build/merge_gate_stats.json]

Per cell (the benchmark's scene, program and online step:
``benchmark/harness.py``'s ``Rank``), after the warm-up, --steps steps
whose merge launches take the kernel's stats pointer
(``kernels/merge.py::STATS``): per particle the batches, the gate tests,
the exact tests, the unbounded candidates, the live candidates and the
slots. On every --every-th step the greedy chain's candidate tests on the
same pool (``chip_smoke.py``'s count, what pick_loop tested) give the
exact and gate tests' shares of them. One JSON line per cell: the medians
and maxima over the first 8192 particles of every step, the two shares,
and the kernel's ms on the last step's pool (CUDA events).

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CELLS = ("dense8k.clutter40", "wide65k.clutter20")
KEEP = 8192                         # particles a step in the distributions


def launch_args(a, kw):
    """A merge_cuda call's (pool, (min_sep, cap, metric))."""
    metric = a[8] if len(a) > 8 else kw.get("metric", 0)
    return list(a[:6]), (a[6], a[7], metric)


def run_cell(name, seed, steps, every, device):
    import numpy as np
    import torch

    import chip_smoke as C
    from benchmark import harness
    from phdslam_tpu_torch.kernels import merge as G
    cell = harness.load_cell(name)
    rk = harness.Rank(cell, seed, (steps + 1) / 1000.0, device)
    rk.warm_up()
    kept, tests, exact, gated, last = [], 0, 0, 0, None
    real = G.merge_cuda

    def counted(*a, **kw):
        nonlocal last
        P = a[0].shape[0]
        st = torch.zeros((P, len(G.STATS)), dtype=torch.int32, device=device)
        out = real(*a, stats=st, **kw)
        last = (a, kw)
        kept.append(st[:KEEP].cpu().numpy())   # the distributions' rows
        return out

    G.merge_cuda = counted
    try:
        for t in range(steps):
            rk.one_step()
            if t % every == every - 1:
                pool, (sep, cap, metric) = launch_args(*last)
                tests += C.merge_tests(pool, sep, cap, metric)
                st = torch.zeros((pool[0].shape[0], len(G.STATS)),
                                 dtype=torch.int32, device=device)
                real(*pool, sep, cap, metric, stats=st)
                st = st.long()
                exact += int(st[:, G.STATS.index("exact_tests")].sum())
                gated += int(st[:, G.STATS.index("gate_tests")].sum())
    finally:
        G.merge_cuda = real
    rk.sync()
    st = np.concatenate(kept).astype(np.int64)
    col = lambda k: st[:, G.STATS.index(k)]
    res = dict(cell=name, seed=seed, steps=steps, launches=len(kept),
               exact_share_of_chain=exact / max(tests, 1),
               gate_share_of_chain=gated / max(tests, 1),
               chain_tests_sampled=tests,
               particles_in_distributions=int(st.shape[0]))
    for k in G.STATS:
        res[f"{k}_median"] = float(np.median(col(k)))
        res[f"{k}_max"] = int(col(k).max())
    pool, (sep, cap, metric) = launch_args(*last)
    res["kernel_ms"] = C.cuda_ms(lambda: real(*pool, sep, cap, metric), 20)
    res["batches_p99"] = float(np.percentile(col("batches"), 99))
    res["live_median_of_steps"] = statistics.median(
        float(np.median(k[:, G.STATS.index("live")])) for k in kept)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--every", type=int, default=50)
    ap.add_argument("--out", type=Path,
                    default=REPO / "build" / "merge_gate_stats.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("merge_gate_stats: needs a CUDA device")
    from phdslam_tpu_torch.bench import gpu_line
    print(gpu_line(), flush=True)
    device = torch.device("cuda", 0)
    out = []
    for name in args.cells:
        res = run_cell(name, args.seed, args.steps, args.every, device)
        print(json.dumps(res), flush=True)
        out.append(res)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

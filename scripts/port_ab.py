"""Time the port's FastSLAM and OSPA auction paths in one checkout, for
comparing two commits on the same card.

    python3 scripts/port_ab.py ROOT TAG

ROOT is the root of a checkout of the repository (its own
``chip_smoke.py`` and ``phdslam_tpu_torch/`` are imported and its kernels
built); TAG labels the lines. Prints the card's name and power limit, then
the dense FastSLAM step (chip_smoke.py's stress stepper at 8192 x 512 x
64: its warm-up, then its timed steps split into glue and the auction, and
the peak device memory of those steps; no plain check, which would add
its own tensors to the peak), the FastSLAM low-clutter cell
at filter seed 0 twice (ms/step, pose error) and the square OSPA auction
alone on the 8 set pairs at each OSPA size. Run it in the parent's tree
and in this one, alternating (parent, change, change, parent), each in a
process of its own:

    git archive HEAD~1 | tar -x -C build/parent
    for t in parent change change parent; do
      python3 scripts/port_ab.py $([ $t = parent ] && echo build/parent \\
          || echo .) $t
    done
"""

import gc
import os
import sys


def dense_fastslam(C, dev, tag):
    """The dense FastSLAM step's ms/step, its auction's share and its
    peak device memory, from a clean peak."""
    import torch
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    _, state, step = C.stress_stepper(C.DENSE_FS, C.FS_WARMUP + C.TIMED, dev,
                                      cfg_file="cfg/fastslam_synth.cfg")
    for t in range(C.FS_WARMUP):
        state, _ = step(state, t)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with C.timers()["auction"] as tm:
        start.record()
        for t in range(C.FS_WARMUP, C.FS_WARMUP + C.TIMED):
            state, _ = step(state, t)
        end.record()
        torch.cuda.synchronize()
    ms = start.elapsed_time(end) / C.TIMED
    auction_ms = tm.ms() / C.TIMED
    print(f"[{tag}] dense FastSLAM step: {ms:.3f} ms/step = glue "
          f"{ms - auction_ms:.3f} + auction {auction_ms:.3f}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)


def main(argv=None):
    root, tag = argv if argv is not None else sys.argv[1:3]
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as C
    from phdslam_tpu_torch.evidence.common import gpu_line
    from phdslam_tpu_torch.kernels import _build
    from phdslam_tpu_torch.kernels import auction as A
    from phdslam_tpu_torch.ops import ospa as O

    dev = torch.device("cuda", 0)
    _build.library()
    print(f"[{tag}] {gpu_line()}", flush=True)
    dense_fastslam(C, dev, tag)
    cell = C.fastslam_cell(dev)
    for _ in range(2):
        errs, _, ms = C.run_fastslam_cell(cell, 0, 1, dev, {})
        print(f"[{tag}] FastSLAM cell seed 0: {ms:.3f} ms/step, pose "
              f"{errs.mean():.4f} m", flush=True)
    eps = O.eps_schedule(dev)
    for n in C.OSPA_SIZES:
        cost = torch.stack([
            O.padded_cost(*C.ospa_sets(n, s, dev)[4], C.OSPA_P, C.OSPA_C)[1]
            for s in range(C.OSPA_SEEDS)]).contiguous()
        budget = O._BIDS_PER_N * n
        ms = C.cuda_ms(lambda: A.auction_square_cuda(cost, eps, budget), 10)
        print(f"[{tag}] square auction [{C.OSPA_SEEDS}, {n}, {n}]: "
              f"{ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()

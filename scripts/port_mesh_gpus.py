"""The port's particle-axis mesh (``phdslam_tpu_torch/parallel/mesh.py``)
across the GPUs of one host, one NCCL rank per GPU.

    python3 scripts/port_mesh_gpus.py

Run from the root of a checkout on a machine with two or more CUDA GPUs
(every visible GPU becomes a rank; ``chip_smoke.py`` phase 9d covers one
card). It imports ``chip_smoke.py`` from the checkout for its steppers and
checks. Prints every GPU's name and power limit, then:

1. the island runner with ``--islands 4 --truth`` over chip_smoke's
   330-step static run on GPU 0 alone, loop and scan (the reference);
2. W ranks spawned from this script (rank r on GPU r, NCCL, a file
   rendezvous in a temporary directory; a failure in any rank fails the
   run), each:
   - the dense static step (8192 x 512 x 64 on the stress stream) at W x
     8192 / W, 4 steps at a threshold that always fires the resample (1.1)
     and one that never does (0), every aux value and state leaf bit for
     bit against the single process (run on the rank's own GPU), launch
     counts from 0, the bytes a step from the mesh's traffic record (one
     read_flag a step; the state's leaves gathered on firing steps only);
   - the dense island step at 4 and 8 islands (8 x 1024: local and
     cross-rank butterfly rounds), never (0) and always (1.1) exchanging,
     4 steps bit for bit against the one-GPU island step, the bytes a step
     (log2(W) exchange_rows calls of the rank's shard when it exchanges,
     nothing else above [n/W, 6] floats);
   - timed with CUDA events (warm-up 3, 16 timed), the split into glue,
     select and merge, the peak device memory, the kernels against plain
     on the last step's inputs: the plain dense step on the rank's GPU,
     the dense sharded step at both thresholds, the 8-island step on the
     rank's GPU and across the ranks at both thresholds;
   - CPHD at 1024 x 128 x 64, the shipped mixed and FastSLAM cfgs and
     cfg/disparity_synth.cfg, 20 steps each, bit for bit;
   - sharded_run_scan over the 330-step run at 256 particles against
     run_scan, bit for bit, mean pose error below 1.5 m;
   - BASELINE config 5: sharded_run_scan at 65,536 particles (W x 65536 /
     W) over the run's first 16 steps at thresholds 0 and 1.1 (never,
     always resampling), warm then timed (host clock), bit for bit
     against run_scan on the rank's GPU, the bytes received a step within
     5 % of (W - 1) / W x (32 B a particle, and the state's 203.7 MB on a
     firing step);
   - the island runner of 1. across the W ranks (torchrun's environment
     set by hand: RANK, WORLD_SIZE, LOCAL_RANK = r, a free localhost
     port), loop and scan: select and merge once a step;
3. the ranks' runner outputs against 1.'s, every file byte for byte
   (metrics.jsonl apart from its ms column, loopTime.log a line a step).

The last line is {"ok": true, "ranks": W, "plain_ms": [...], "dense_ms":
{threshold: [...]}, "island_ms": {threshold: [...]}, "island_one_gpu_ms":
[...], "dense_mb": {threshold: MB}, "island_mb": {"n threshold": MB},
"config5": {threshold: {"ms": [...], "mb": MB, "predicted_mb": MB}}}
(times per rank; MB received a step by rank 0).
"""

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402

ISLANDS = 4          # the runner's
TIMED_ISLANDS = 8    # the timed island step's


def rank_main(rank, world, device_type, backend, tmp, run_dir, ports):
    """Step 2 in rank ``rank``; writes its readings to tmp/rank<r>.json."""
    import os

    import torch
    from phdslam_tpu_torch.parallel.mesh import make_mesh
    C.LOG_PREFIX = f"[rank {rank}/{world}] "
    dev = torch.device(device_type, rank) if device_type == "cuda" \
        else torch.device(device_type)
    stats, out = {}, dict(rank=rank)
    mesh = make_mesh(backend, dev, rank=rank, world_size=world,
                     init_method=f"file://{Path(tmp, 'rdv')}")
    try:
        shape = "x".join(str(C.DENSE[k]) for k in "PFM")
        what = (f"dense sharded step ({world} {backend} ranks x "
                f"{C.DENSE['P'] // world}, one GPU each)")
        out["dense_mb"] = C.mesh_dense_pairs(dev, mesh)
        out["island_mb"] = C.mesh_island_pairs(dev, mesh)
        C.reset_peak_memory()
        _, state, step = C.stress_stepper(C.DENSE, C.WARMUP + C.TIMED, dev)
        _, out["plain_ms"] = C.timed_steps(stats, state, step, C.WARMUP,
                                           "plain dense step", shape,
                                           peak=True)
        n, p = TIMED_ISLANDS, C.DENSE["P"] // TIMED_ISLANDS
        _, state, step, _ = C.island_stepper(C.DENSE, C.WARMUP + C.TIMED,
                                             dev, n, 0.0)
        _, out["island_one_gpu_ms"] = C.timed_steps(
            stats, state, step, C.WARMUP,
            f"dense island step ({n} x {p}, one GPU, threshold 0.0)", shape)
        out["dense_ms"], out["island_ms"] = {}, {}
        for thresh in C.MESH_THRESHOLDS:
            C.reset_peak_memory()
            label = f"{what}, threshold {thresh}"
            _, state, step = C.stress_stepper(
                C.DENSE, C.WARMUP + C.TIMED, dev, mesh=mesh,
                resampleThresh=thresh)
            _, out["dense_ms"][thresh] = C.timed_steps(
                stats, state, step, C.WARMUP, label, shape, peak=True)
            out["dense_peak_gib"] = stats["peak_gib"][label]
            _, state, step, _ = C.island_stepper(
                C.DENSE, C.WARMUP + C.TIMED, dev, n, thresh, mesh=mesh)
            _, out["island_ms"][thresh] = C.timed_steps(
                stats, state, step, C.WARMUP,
                f"dense island step ({n} x {p} on {world} {backend} ranks,"
                f" threshold {thresh})", shape)
        out["side"] = C.mesh_side_paths(dev, mesh)
        out["scan_launches"], out["scan_err"] = C.mesh_scan(dev, mesh,
                                                            run_dir)
        out["config5"] = C.config5_mesh_scans(dev, mesh, run_dir)
    finally:
        mesh.close()
    truth = str(Path(run_dir, "truth.txt"))
    for mode, port in zip(("loop", "scan"), ports):
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
        launches, run_s, _ = C.run_cli(C.runner_args(
            run_dir, Path(run_dir, f"mesh_{mode}"), dev, extra=(
                "--mode", mode, "--islands", str(ISLANDS), "--truth", truth,
                "--dist-backend", backend)), C.timers())
        C.log(f"runner --islands {ISLANDS} --mode {mode} on {world} "
              f"{backend} ranks: launches {launches}, run {run_s:.1f} s")
        out[f"runner_{mode}"] = dict(launches=launches, run_s=run_s)
    Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))


def run(world, device_type, backend, dev0):
    """Steps 1-3 on ``world`` ranks; returns the ranks' readings."""
    import torch.multiprocessing as mp
    stats = dict(shipped_ms_per_step=float("nan"),
                 shipped_pose_err=float("nan"))
    with tempfile.TemporaryDirectory() as run_dir, \
            tempfile.TemporaryDirectory() as tmp:
        C.phase_island_runner(dev0, stats, run_dir)
        t0 = time.perf_counter()
        mp.spawn(rank_main, args=(world, device_type, backend, tmp, run_dir,
                                  C.free_ports(2)),
                 nprocs=world, join=True)
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(world)]
        n_steps = len(Path(run_dir, "islands_loop",
                           "loopTime.log").read_text().split())
        for r in ranks:
            for mode in ("loop", "scan"):
                C.check_launches(r[f"runner_{mode}"]["launches"],
                                 dict(select=n_steps, merge=n_steps),
                                 f"rank {r['rank']} runner {mode}")
        for mode in ("loop", "scan"):
            n_files = C.same_run_outputs(
                Path(run_dir, f"islands_{mode}"),
                Path(run_dir, f"mesh_{mode}"),
                f"runner --islands {ISLANDS} {mode} on {world} ranks")
            C.log(f"runner --islands {ISLANDS} --mode {mode} on {world} "
                  f"{backend} ranks: its {n_files} files equal the one-GPU "
                  "run's (every state_estimate log byte for byte)")
        C.log(f"ranks' part {time.perf_counter() - t0:.1f} s")
    return ranks


def main():
    import subprocess

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("port_mesh_gpus: needs two or more CUDA GPUs",
              file=sys.stderr)
        return 2
    world = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        C.log(f"gpu: {line.strip()}")
    C.log(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    from phdslam_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    C.log(f"build {time.perf_counter() - t0:.1f} s")
    dev0 = torch.device("cuda", 0)
    torch.cuda.set_device(dev0)
    ranks = run(world, "cuda", "nccl", dev0)
    per = lambda key, t: ", ".join(f"{r[key][t]:.3f}" for r in ranks)
    C.log("NCCL, one rank per GPU, ms a step per rank: plain dense step on "
          "the rank's GPU " + ", ".join(f"{r['plain_ms']:.3f}" for r in ranks)
          + f"; {TIMED_ISLANDS}-island step on the rank's GPU "
          + ", ".join(f"{r['island_one_gpu_ms']:.3f}" for r in ranks)
          + "; " + "; ".join(
              f"threshold {t}: sharded step {per('dense_ms', t)}, "
              f"{TIMED_ISLANDS}-island step across the ranks "
              f"{per('island_ms', t)}" for t in ranks[0]["dense_ms"])
          + "; peak " + ", ".join(f"{r['dense_peak_gib']:.2f}"
                                   for r in ranks) + " GiB")
    C.log("MB received a step, rank 0: the resample's gather "
          + ", ".join(f"threshold {t} {mb:.3f}"
                      for t, mb in ranks[0]["dense_mb"].items())
          + "; the butterfly " + ", ".join(
              f"{k.split()[0]} islands threshold {k.split()[1]} {mb:.3f}"
              for k, mb in ranks[0]["island_mb"].items()))
    c5 = {t: dict(ms=[r["config5"][t]["ms"] for r in ranks],
                  mb=ranks[0]["config5"][t]["mb"],
                  predicted_mb=ranks[0]["config5"][t]["predicted_mb"],
                  peak_gib=[r["config5"][t]["peak_gib"] for r in ranks])
          for t in ranks[0]["config5"]}
    C.log(f"config 5 sharded_run_scan ({world} x "
          f"{C.CONFIG5['P'] // world}), ms a step per rank and MB received "
          "a step by rank 0 (predicted): " + "; ".join(
              f"threshold {t} " + ", ".join(f"{x:.3f}" for x in v["ms"])
              + f" ms, {v['mb']:.3f} MB ({v['predicted_mb']:.3f}), peak "
              + ", ".join(f"{x:.2f}" for x in v["peak_gib"]) + " GiB"
              for t, v in c5.items()))
    print(json.dumps(dict(
        ok=True, ranks=world, plain_ms=[r["plain_ms"] for r in ranks],
        dense_ms={t: [r["dense_ms"][t] for r in ranks]
                  for t in ranks[0]["dense_ms"]},
        island_ms={t: [r["island_ms"][t] for r in ranks]
                   for t in ranks[0]["island_ms"]},
        island_one_gpu_ms=[r["island_one_gpu_ms"] for r in ranks],
        dense_mb=ranks[0]["dense_mb"], island_mb=ranks[0]["island_mb"],
        config5=c5)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

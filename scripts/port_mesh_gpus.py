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
     8192 / W, 4 steps with the resample forced, every aux value and state
     leaf bit for bit against the single process (run on the rank's own
     GPU), launch counts from 0;
   - the dense sharded step timed with CUDA events beside the plain dense
     step on the same GPU (warm-up 3, 16 timed), the split into glue,
     select and merge, the peak device memory, the kernels against plain
     on the last step's inputs;
   - CPHD at 1024 x 128 x 64, the shipped mixed and FastSLAM cfgs and
     cfg/disparity_synth.cfg, 20 steps each, bit for bit;
   - sharded_run_scan over the 330-step run at 256 particles against
     run_scan, bit for bit, mean pose error below 1.5 m;
   - the island runner of 1. across the W ranks (torchrun's environment
     set by hand: RANK, WORLD_SIZE, LOCAL_RANK = r, a free localhost
     port), loop and scan: select and merge once a step;
3. the ranks' runner outputs against 1.'s, every file byte for byte
   (metrics.jsonl apart from its ms column, loopTime.log a line a step).

The last line is {"ok": true, "ranks": W, "dense_ms": [...],
"plain_ms": [...]} (per rank).
"""

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402

ISLANDS = 4


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
        out["dense_launches"] = C.mesh_pair(
            lambda m: C.stress_stepper(C.DENSE, C.MESH_STEPS, dev, mesh=m,
                                       resampleThresh=1.1)[1:],
            C.MESH_STEPS, mesh, what)
        C.reset_peak_memory()
        _, state, step = C.stress_stepper(C.DENSE, C.WARMUP + C.TIMED, dev)
        _, out["plain_ms"] = C.timed_steps(stats, state, step, C.WARMUP,
                                           "plain dense step", shape,
                                           peak=True)
        C.reset_peak_memory()
        _, state, step = C.stress_stepper(C.DENSE, C.WARMUP + C.TIMED, dev,
                                          mesh=mesh)
        _, out["dense_ms"] = C.timed_steps(stats, state, step, C.WARMUP,
                                           what, shape, peak=True)
        out["dense_peak_gib"] = stats["peak_gib"][what]
        out["side"] = C.mesh_side_paths(dev, mesh)
        out["scan_launches"], out["scan_err"] = C.mesh_scan(dev, mesh,
                                                            run_dir)
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
            C.check_launches(r["dense_launches"],
                             dict(select=C.MESH_STEPS, merge=C.MESH_STEPS),
                             f"rank {r['rank']} dense")
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
    C.log("dense sharded step, NCCL, one rank per GPU: " + "; ".join(
        f"rank {r['rank']} {r['dense_ms']:.3f} ms (plain dense step on its "
        f"GPU {r['plain_ms']:.3f} ms), peak {r['dense_peak_gib']:.2f} GiB"
        for r in ranks))
    print(json.dumps(dict(ok=True, ranks=world,
                          dense_ms=[r["dense_ms"] for r in ranks],
                          plain_ms=[r["plain_ms"] for r in ranks])))
    return 0


if __name__ == "__main__":
    sys.exit(main())

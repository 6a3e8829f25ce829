#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (phdslam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, nvcc and
PyTorch; JAX is neither needed nor imported. Phases, each printing its
result and its seconds on its own line; any failure raises, so the exit
code is not 0:

  1. build  - compile csrc/*.cu with nvcc for sm_90a, one nvcc per source
     started together (set-up time)
  2. kernels against their plain PyTorch versions on the card, each timed
     at the dense shape beside its plain version and its bound:
     - pre-update: at 8192 x 512 and 65,536 x 128 (the benchmark cells'
       shapes, both timed), 37 x 129 and 1 x 5, on slots of every range
       class, bearings that wrap near +-pi and covariances from 1e-6 to
       1e4: all 15 channels bit for bit (a channel that differs is named
       with its largest ulp gap)
     - select and select by index: the shipped (256 x 128 x 64) and dense
       (8192 x 512 x 64) shapes, normalised, raw and n_valid < M; the
       by-index kernel picks what the payload kernel picks, and the gather
       at its indices reproduces the payload; registers and CTAs per SM;
       at the dense shape, the share of rows whose argmax rounds exit
       early, the mean rounds run per row and the mean live slots per
       particle
     - merge: the dense pool ([8192, 1088] -> 512, metrics 0 and 1), the
       shipped pool ([256, 704] -> 128), an odd P, an odd cap and a pool of
       exact weight ties ([1024, 1088] -> 512); two launches on the dense
       pool bit-identical; CTAs per SM
     - select4 and select4 by index: the shipped mixed (256 x 128 x 64),
       dense (8192 x 512 x 64) and odd-P (1001) shapes, k1 = 8, with the
       same by-index checks, registers, CTAs per SM and early exits (raw
       values)
     - merge4: [256, 704] -> 128 at min_sep 1.0, [8192, 1088] -> 512 at
       1.0 and 5.0, an odd P (1001), an odd cap (77), a pool of exact
       weight ties and pools of zero, singular and slightly indefinite
       covariances at 1.0 and 5.0 ([1024, 1088] -> 512); two launches on
       the dense pool bit-identical; CTAs per SM; the share of candidate
       tests each early exit decides (a replay of the pick loop)
     - merge3: the shipped disparity pool ([64, 496] -> 64), an odd P
       ([1001, 496] -> 64) and the dense pool ([8192, 560] -> 128), each
       timed beside its bound, min_sep 4; two launches on the dense pool
       bit-identical; registers and CTAs per SM
     - esf: [1024, 64], [256, 64], [1001, 48] with 9 trailing -inf slots,
       [7, 1], [64, 256], [1024, M] at M = 1, 2, 33, 65 and 128, [1024,
       64] with a random 30 % of each particle's entries -inf and with
       every other particle all -inf, each timed beside its bound; bit for
       bit against the plain version; registers and CTAs per SM; the
       kernels' log1p against the library's log1pf on every float in [0,
       inf), bit for bit
     - auction (FastSLAM's joint association, clamp, rounds and readout in
       one launch) on raw benefits: [8192, 64, 512], [256, 64, 128], [1001,
       64, 128], every other particle with no live pair, NaN entries, and
       budgets of 1 and 2 rounds (the readout's fallback), each timed
       beside its plain version and its bound (counted on the rounds each
       launch ran); columns and rounds bit for bit; the rounds per particle
       and budget hits; registers and CTAs per SM on each path
     - OSPA auction (the in-loop OSPA's square eps-scaled auction): the
       padded costs of scripts/ospa_latency.py's 8 random set pairs at n =
       16, 64 and 256 (p = 1, c = 5; n = 256 keeps the cost in shared
       memory and registers), one launch a size, and at n = 64 with 2
       rounds a phase (the clean-up): owners and rounds per phase bit for
       bit against the plain version, timed beside it and its bound
       (counted on the bids made), the microseconds a round, registers and
       CTAs per SM; then ospa_torch, the entry point, on every pair with
       its launches counted from 0, within 2e-2 of ospa_np (card term
       1e-4), and its time a call
     - run sets: select and select4, both modes (select normalised and
       raw), on 4 runs of the shipped shape blockwise, each run with its
       own measurement set (select: and its own n_valid): one launch bit
       for bit as 4 single-run launches on the particle slices, and
       against the plain version on the same per-run inputs
     - past the old limits, each against plain and timed: select and
       select4 (both modes) at 64 x 4096 x 64 (the wide-row kernels), merge
       [64, 7745] -> 256, merge4 [64, 3521] -> 256, merge3 [64, 5052] -> 128
       (the device-memory pools)
     Values are held to rtol 2e-4 / atol 1e-5 (payload only where w > 0;
     indices exactly); a particle whose outputs miss that (a near-tie
     picked in another order) is counted, and a check fails above 0.1 % of
     the particles.
  3. static main path - the runner (loop mode, --device cuda) over a
     330-step simdata run at cfg/ackerman_synth.cfg: the log contract,
     select and merge launched once per update step, mean pose error below
     1.5 m, both kernels against their plain versions on the run's last
     launch, and select's early exits and live slots on that launch; then
     the runner in scan mode on the same run (launch counts from 0): every
     state_estimate log byte for byte the loop run's, metrics.jsonl the
     same apart from its ms column (phases 4, 5, 6 and 6d do the same
     after their loop runs: mixed, disparity, CPHD, FastSLAM)
  3b. resume - each filter's runner over the first 120 steps of that run
     (mixed: of phase 4's) with --checkpoint-every 50, then a fresh
     out-dir holding only ckpt_000050.npz run with --resume (launch counts
     from 0): static, FastSLAM (clutter 2, std_range 0.25) and mixed,
     steps 51-119 byte-identical to the straight run's (metrics apart from
     ms); CPHD and mixed with birth_velocity_init 1, step 51 differing (a
     checkpoint holds no previous measurements, as in JAX) and every
     resumed step with finite weights (CPHD: a normalised cardinality
     line); then the disparity runner over its 100 steps, resumed from
     step 50 byte for byte; each filter's kernels launched once per
     resumed update step
  4. mixed main path - the runner (loop mode, --device cuda) at
     cfg/mixed_synth.cfg's full width (256 particles x 128 static + 128
     dynamic slots x 64 measurements) over the 150-step scenario of
     scripts/mixed_evidence.py (40 landmarks, three movers, seed 500): the
     log contract with the dynamic map on line 3, select, select4, merge
     and merge4 launched once per update step, mean pose error below
     2.0 m, on at least half the steps where a mover has been in view 4+
     steps in a row a dynamic component of weight >= 0.05 within 2 m of
     it, the four kernels against their plain versions on the last launch;
     then 40 steps with select_by_index = 1, which must launch the two
     by-index kernels once per update step and the payload kernels never
  5. disparity main path - the runner (loop mode, --device cuda) on
     cfg/disparity_synth.cfg (64 particles x 64 slots x 64 cloud points x
     48 measurements) over data/disparity_synth/ (100 steps): the log
     contract (12-DOF pose, map stride 13), merge3 launched once per step
     with measurements and no other kernel, mean camera position error
     against traj.txt below 1.5 m, merge3 against plain on the last launch
  6. CPHD main path - the runner (loop mode) on cfg/ackerman_synth.cfg
     with filter_type = 1 (256 x 128 x 64, max_cardinality 255) over the
     static phase's 330-step run: esf, select (raw) and merge launched
     once per update step, mean pose error below 1.5 m, every cardinality
     line a normalised log-pmf (exp finite, logsumexp 0 within 1e-3), the
     three kernels against plain on their last launches (esf bit for bit),
     and merge against plain on every launch of the run (its inputs and
     outputs kept on the card, compared after the run)
  6b. seed envelopes - the disparity run of phase 5 and the CPHD run of
     phase 6 at --seed 0 .. 4 (the filter's seed; the data stay): each
     seed's mean error, then their mean and standard deviation; every seed
     below 1.5 m
  6e. Monte-Carlo envelope - eval/batch.py::run_batch on
     scripts/round3_evidence.py::phase_variants' setup (cfg/ackerman_synth.cfg
     at 256 particles, make_scenario(rng(42), 80 landmarks, 200 steps), 20
     runs at control noise (0.2, 0.01), the map scored every 4 steps) for
     the PHD arm and the CPHD arm (filter_type 1, max_cardinality 127),
     launch counts from 0 before each: select, merge and (CPHD) esf once
     per update step; the late-half mean OSPA within the JAX record's
     ospa_late_std of its ospa_late_mean (results/round3_evidence.json),
     the late-half pose error below 1.5 m; run_batch's ms per step; then
     both arms again with vmapped=True (the 20 runs in one chunk): the
     same gates, each kernel launched once per step of the chunk (not per
     run), ms per run-step beside the sequential path's. Then:
     - one batched step of 8 runs (after 30 steps together) against each
       run stepped alone from the same state and draws, the resample
       forced, PHD and CPHD: each run's log-likelihood within 1e-5
       relative, resample picks differing on at most 0.1 % of particles
     - FastSLAM (cfg/fastslam_synth.cfg) and mixed (cfg/mixed_synth.cfg)
       run_batch, 4 runs x 20 steps, sequential and vmapped: every pose
       finite, the kernels launched once per update step of each run or
       once per step of the chunk; the gap between the pose curves logged
     - fill probe: vmapped at JAX's default chunk (65536 // 256 = 256 runs
       of 256 particles) over the first 50 steps, PHD and CPHD: ms per
       run-step and peak device memory (with --profile, the busy share and
       the ops with the most device time); one step's draws for 20 and for
       256 runs, from a generator a run against one generator
  6f. no host sync - 4 runs of the static cfg at the shipped shape stepped
     together on the stress stream, run 1 without measurements at step 1
     (the per-run update gate) and so without CPHD births at step 2, PHD
     and CPHD: three steps under torch.cuda.set_sync_debug_mode "warn"
     (every sync named by the port's line that made it) and then "error"
  6c. FastSLAM main path - scripts/fastslam_evidence.py's low-clutter cell
     (cfg/fastslam_synth.cfg at clutter 2, std_range 0.25, start pose 0;
     256 particles x 128 slots x 64 measurements, 150 steps of
     make_scenario(rng(7), 80 landmarks) and generate_run(rng(8))) through
     slam_step on the card: the auction launched once per update step and
     against plain on its last launch, bit for bit; filter seeds 0 .. 4,
     each seed's mean pose error below 1.5 m and their mean below 1.0 m;
     gated ML (fastslam_assoc 0) at seed 0, logged, the auction never
     launched
  6d. FastSLAM runner - cfg/fastslam_synth.cfg as shipped (clutter 20, not
     gated on tracking) through the runner on phase 3's 330-step run with
     --truth and --predict-time: the log contract, the ospa column,
     predicttime.log, state100.pkl and its `profile` replay; then 12 steps
     with map_estimate 3 and --mat-export (particlesXXXXX.mat with the
     MAP and EAP maps, the logs holding the EAP map)
  7. dense step - 8192 x 512 x 64 (the static cfg at bench.py's dense
     shape and stress stream): 3 warm-up steps, 16 timed with CUDA events,
     split into pre-update and glue, select and merge; then both kernels
     against their plain versions on the last step's own inputs
  8. dense mixed step - cfg/mixed_synth.cfg with the same overrides and
     stream: the same timing, split into glue, select, select4, merge and
     merge4, then the four kernels against plain on the last step's inputs
  9. dense CPHD and disparity steps - stress shapes, as the dense static
     and mixed ones: CPHD at BASELINE config 3's shape (1024 x 128 x 64,
     max_cardinality 127, gate_births 1 at 9.0, the dense overrides) on the
     stress stream, split into glue, select, esf and merge; disparity at
     8192 particles x 128 slots x 64 points x 48 measurements (clouds
     805 MB) on the shipped measurement stream, split into glue and merge3;
     the kernels against plain on the last step's inputs
  9b. dense FastSLAM step - cfg/fastslam_synth.cfg at 8192 x 512 x 64 on
     the stress stream from empty maps: 8 warm-up steps, 16 timed, split
     into glue and the auction (its clamp, rounds and readout in the one
     launch) and the peak device memory of the steps; live slots and
     rounds per particle
  9c. islands - the island model (parallel/island.py): the dense static
     step as phase 7's at 8 islands of 1024, never exchanging (threshold
     0) and always (1.1), each round after the plain dense step, two
     rounds: the timing split, peak device memory, select and merge
     against plain on the last step's inputs, the exchange alone with its
     trigger on and off, one more step without a host sync; then
     the runner with --islands 4 and --truth over phase 3's 330-step run,
     loop and scan mode: the log contract, select and merge once per
     step, the island weights normalised within 1e-5, the local (loop) or
     global (scan) weights summing to 1 within 1e-3, finite poses; ms/step,
     pose error and exchanges beside phase 3's plain run (not gated: the
     reference's butterfly pool-mass defect applies here too)
  9d. mesh - particle-axis sharding across processes (parallel/mesh.py):
     first torch's per-row cumsum and sum on the card at the dense island
     pools (8 rows of 2048, 4 of 4096), rows taken 1, 2 and 4 at a time:
     the floats that differ alone (logged), none as among all
     (ops/resample.py's layout_runs); 100 cumsums of the same weights at
     8192 to 262,144 floats, one row and as the first of two rows: the
     distinct results (logged), one for the two-row form (F9); (a)
     one NCCL rank on this card, in this process: the dense static step
     (phase 7's shape and stream) through sharded_step against slam_step
     on the same draws, MESH_STEPS steps at a threshold that always fires
     the resample (1.1) and one that never does (0), every aux value and
     state leaf bit for bit, launch counts from 0 (select and merge once
     a step), the mesh's traffic record a step (one read_flag; the
     state's leaves gathered on the firing steps only); then timed beside
     the plain step at both thresholds, ISLAND_ROUNDS rounds, with the
     split, the peak, the kernels against plain on the last step's inputs,
     and one step in which the host waits for the device exactly once, at
     read_flag (set_sync_debug_mode "warn"); (b) MESH_RANKS gloo ranks
     spawned from this script, all on this card (a file rendezvous in a
     temporary directory; a failure in any rank fails the phase): the
     dense static step at MESH_RANKS x P / MESH_RANKS at both thresholds
     and the dense island step at MESH_ISLANDS islands, never (0) and
     always (1.1) exchanging, bit for bit against the single process,
     launches and the bytes a step per rank (the butterfly: log2(W)
     exchange_rows calls of the rank's shard, no gather larger than [n/W,
     6] floats); the dense static step timed with its peak per rank and
     the kernels against plain on the last step's inputs (two processes
     sharing one card through gloo: not a multi-GPU figure); CPHD at 1024
     x 128 x 64, the shipped mixed and
     FastSLAM cfgs and cfg/disparity_synth.cfg, MESH_SIDE_STEPS steps
     each, bit for bit, launches equal to the single process's;
     sharded_run_scan over phase 3's run at 256 particles against
     run_scan, bit for bit, mean pose error below 1.5 m; in (a) and (b)
     also BASELINE config 5 over the ranks, sharded_run_scan at 65,536
     particles over the run's first 16 steps at thresholds 0 and 1.1,
     warm then timed, bit for bit against run_scan, one read_flag a step,
     the bytes received a step within 5 % of (W - 1) / W x (32 B a
     particle, and the state's 203.7 MB on a firing step), and the dense
     sharded disparity step (8192 x 128 x 64 points x 48, 3 steps) bit
     for bit, its traffic exactly the weights and poses (label step) and
     the pose, weights and clouds gathered on every step (label resample,
     JAX's ungated jnp.take); in (a) the dense sharded disparity step
     timed beside the plain one; (c) the runner
     with --islands 4 --truth --dist-backend gloo on those ranks over
     phase 3's run, loop and scan: every file of phase 9c's one-card run
     byte for byte (metrics.jsonl apart from its ms, loopTime.log a line
     a step), select and merge once a step in each rank
 9e. the measuring entry points, each with the launch counts from 0:
     python3 -m phdslam_tpu_torch.bench as a user runs it (its JSON line:
     metric ms_per_slam_step_8192p_cuda, the three modes' ms per step,
     vs_baseline from the pinned CPU anchor; select and merge once a
     step), then python3 -m phdslam_tpu_torch.stage_profile at both
     shapes (its stage lines and JSON line; select, select by index,
     select4, merge, merge4, merge3 and esf launched); then the dense
     step of each of the bench's modes (exact; merge_mode 1; merge_mode 1
     with select_top_k 2) through phase 7's timing: select at k1 = 8, 4,
     2 and merge on pools of 1088, 832 and 704 candidates, both against
     plain on the last step's inputs; python3 -m phdslam_tpu_torch.bench
     --quick (512 x 128) as a user runs it, its JSON line
 9f. the evidence entry points (phdslam_tpu_torch/evidence/), each as a
     user runs it (main(argv), --device cuda, the results into a temporary
     file) with the launch counts from 0: round3's phases vmap, merge,
     variants, parity and cphd_cpu and mixed (default, --informed,
     --labeled --set keepOobDynamic=1) and disparity (main, --oracle) at
     the JAX scripts' --quick sizes, the CPU reference legs cut to their
     first 3 steps; the FastSLAM cells (2, 0.25) of filter types 2 and 0,
     cphd_dwell and ospa_latency in full. Each kernel launched once per
     update step its filters took (counted at the filters' own gates:
     slam_step and disparity_step with a measurement, each ospa_torch
     call), each kernel it launched against plain on its last inputs, the
     entry with every key of the JAX record (results/), its numbers
     finite, its pose errors within PERF.md section 2's bars (the static,
     CPHD and disparity arms 1.5 m, mixed 2.0 m, FastSLAM's low-clutter
     cells 1.5 m), the CPHD dwell error within 2.0 and the OSPA gap within
     2e-2
 9g. BASELINE config 5 (eval_baselines.py's config 5): one filter of
     65,536 particles (cfg/ackerman_synth.cfg, 128 slots, 64
     measurements) on this card, run_scan over the first 16 steps of
     phase 3's run, a warm pass then a timed one ending in a synchronise,
     exact and merge_mode 1: ms a step, the split into glue, select and
     merge, peak device memory; select (k1 8 and 4) and merge (the step's
     own pools) on each pass's last inputs against plain (select in
     chunks of 8192 particles; two merge launches bit-identical), each
     timed beside its bound; then the runner in scan mode at that width
     over the whole 330-step run: a log a step with every particle,
     loopTime.log and metrics.jsonl, select and merge once a step, mean
     pose error below 1.5 m, peak memory
 9h. constant-velocity motion (motion_type 0, cfg/cv_synth.cfg) at 256 x
     128 x 64 on phase 3's measurement sets: 20 card steps, then one step
     from that state on one set of draws on the card and on the CPU
     (plain versions): poses, log-weights, maps and aux values within
     rtol 2e-4 / atol 1e-5, resample indices exact, at most 0.1 % of the
     particles differing; the dense CV step timed beside the dense
     Ackerman step, two rounds
 10. the seconds of the whole run, the card's name and power limit, the
     kernels' JSON line, then {"ok": true, "device": {...}} last

    python3 chip_smoke.py --profile

adds, before the JSON lines, a torch.profiler pass over the static step at
the dense and the shipped shape, the dense CPHD step, the dense disparity
step and the FastSLAM step at the dense and the shipped shape: host wall
time, the device's busy share and the ops with the most device time (the
breakdown in PERF.md); and the fill probe's busy share.
"""

from __future__ import annotations

import functools
import gc
import json
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RTOL, ATOL = 2e-4, 1e-5
MAX_DIFFER = 1e-3                   # share of particles allowed to differ
SHIPPED = dict(P=256, F=128, M=64)
DENSE = dict(P=8192, F=512, M=64)
ODD = dict(P=1001, F=128, M=64)
K1 = 8
S_LOOP = 7                          # the channels the select loops read
DENSE_CHUNK = 512                   # particles per plain-select comparison
MERGE_CASES = [                     # (P, K, cap, metric, min_separation)
    (8192, 1088, 512, 0, 5.0),
    (256, 704, 128, 0, 5.0),        # the shipped cfg's pool: F + M k1 + M
    (8192, 1088, 512, 1, 0.6),
    (1001, 1088, 512, 0, 5.0),      # odd P
    (512, 1088, 77, 0, 5.0),        # odd cap
]
MERGE4_CASES = [                    # (P, K, cap, min_separation)
    (8192, 1088, 512, 1.0),         # the dense pool, the shipped dynamic gate
    (256, 704, 128, 1.0),           # the shipped mixed pool
    (8192, 1088, 512, 5.0),
    (1001, 1088, 512, 1.0),         # odd P
    (512, 1088, 77, 1.0),           # odd cap
]
MERGE_TIES = [                      # exact weight ties throughout
    (1024, 1088, 512, 0, 5.0),
]
MERGE_POOL_CASES = [                # tests/merge_pools.py's pools:
    ("course", 8192, 1088, 512, 0, 5.0),    # dense8k's, along a course
    ("course", 65536, 704, 128, 0, 5.0),    # wide65k's
    ("chain", 1024, 1088, 512, 0, 5.0),     # chains through the batches
    # unbounded candidates (huge, tiny, singular, indefinite, past the
    # condition bound), reach outliers, ties; no NaN or infinity, which the
    # plain version's float32 on the CPU rounds otherwise (sweep.py's
    # --against holds those bit for bit against another build)
    ("finite_outliers", 1024, 1088, 512, 0, 5.0),
    ("finite_outliers", 1024, 1088, 512, 1, 0.6),
]
MERGE4_TIES = [(1024, 1088, 512, 1.0)]
MERGE4_DEGENERATE = [               # zero, singular, indefinite covariances
    (1024, 1088, 512, 1.0),
    (1024, 1088, 512, 5.0),
]
MERGE3_CASES = [                    # (P, K, cap, min_separation)
    (8192, 560, 128, 4.0),          # dense: 128 + 48 x 8 + 48 candidates
    (64, 496, 64, 4.0),             # the shipped disparity pool
    (1001, 496, 64, 4.0),           # odd P
]
ESF_CASES = [                       # (P, M, n_pad): n_pad trailing -inf
    (1024, 64, 0),                  # slots; -1: a random 30 % of each
    (256, 64, 0),                   # particle's entries -inf; -2: every
    (1001, 48, 9),                  # other particle all -inf. The dense
    (7, 1, 0),                      # CPHD shape first, then the shipped
    (64, 256, 0),                   # one
    (1024, 1, 0), (1024, 2, 0), (1024, 33, 0), (1024, 65, 0),
    (1024, 128, 0),
    (1024, 64, -1),
    (1024, 64, -2),
]
WIDE = dict(P=64, F=4096, M=64)     # select rows past the register rows
WIDE_MERGES = [                     # (kernel, P, K, cap): pools past smem
    ("merge", 64, 7745, 256), ("merge4", 64, 3521, 256),
    ("merge3", 64, 5052, 128),
]
ENVELOPE_SEEDS = range(5)
RUN_STEPS = 330
POSE_BAR_M = 1.5
MIXED_LANDMARKS, MIXED_STEPS = 40, 150
MIXED_POSE_BAR_M = 2.0
MOVER_SHARE = 0.5                   # settled mover steps confirmed, at least
BY_INDEX_STEPS = 40
DISP_POSE_BAR_M = 1.5
DENSE_CPHD = dict(P=1024, F=128, M=64)
DENSE_DISP = dict(P=8192, F=128, M=48)
DISP_WARMUP = 8                     # fills the dense disparity map first
WARMUP, TIMED = 3, 16
AUCTION_CASES = [                   # (P, M, F, kind): raw [P, M, F]
    (8192, 64, 512, ""),            # the dense FastSLAM shape
    (256, 64, 128, ""),             # cfg/fastslam_synth.cfg's shape
    (1001, 64, 128, ""),            # odd P
    (256, 64, 128, "gated"),        # every other particle: no pair live
    (256, 64, 128, "nan"),          # NaN entries in the raw benefit
    (256, 64, 128, "budget 1"),     # the readout's fallback: rows left
    (256, 64, 128, "budget 2"),     # unassigned at the budget
]
# float32 operations per (round, row, column) of the auction: the value
# (benefit - price), the compares for the best and the second best, the
# NaN test; counted for every row of every round run (the kernel scans
# only the unassigned rows, so this overstates the work after round 1)
AUCTION_OPS = 4
# scripts/fastslam_evidence.py's low-clutter cell (evidence/fastslam.py's
# cell_config and cell_data): 256 particles, 150 steps, scenario seed 7
# (80 landmarks), run seed 8, clutter 2, std_range 0.25
FS_CELL = (2.0, 0.25, 2)
FS_STEPS, FS_PARTICLES = 150, 256
FS_SEEDS = range(5)
FS_SEED_BAR_M, FS_MEAN_BAR_M = 1.5, 1.0
FS_SHORT_STEPS = 12                 # the runner run with .mat files
DENSE_FS = dict(P=8192, F=512, M=64)
FS_WARMUP = 8                       # the dense step's maps start empty
PROFILE_WARMUP, PROFILED, PROFILE_ROWS = 8, 4, 12
# the in-loop OSPA: scripts/ospa_latency.py's cases (set sizes, 8 seeds
# each, p = 1, c = 5), ospa_np within OSPA_TOL (tests/test_ospa.py's
# large-set bar), and a case of OSPA_BUDGET rounds a phase at n = 64
OSPA_SIZES, OSPA_SEEDS, OSPA_P, OSPA_C = (16, 64, 256), 8, 1.0, 5.0
OSPA_TOL, OSPA_CARD_TOL = 2e-2, 1e-4
OSPA_BUDGET_N, OSPA_BUDGET = 64, 2
# checkpoint / resume: the static runner over RESUME_STEPS steps of phase
# 3's run with --checkpoint-every RESUME_EVERY, then --resume from the
# checkpoint after step RESUME_FROM alone
RESUME_STEPS, RESUME_EVERY, RESUME_FROM = 120, 50, 50
# the Monte-Carlo envelope: scripts/round3_evidence.py::phase_variants
# (evidence/common.py's mc_base_cfg and mc_scenario: cfg/ackerman_synth.cfg
# at 256 particles, make_scenario(rng(42), 80 landmarks, 200 steps)), 20
# runs at control noise (0.2, 0.01), the map scored every 4 steps, and the
# JAX package's record of it
MC_RUNS, MC_STEPS = 20, 200
MC_CONTROL_NOISE, MC_EVERY, MC_POSE_BAR_M = (0.2, 0.01), 4, 1.5
MC_ARMS = (("PHD", {}), ("CPHD", dict(filterType=1, maxCardinality=127)))
MC_RECORD = "results/round3_evidence.json"
# the run axis (run_batch(vmapped=True)): phase 2's per-run measurement
# sets; the one-step comparison (MC_STEP_RUNS runs stepped together for
# MC_STEP_AT steps, then one more step batched and run by run; per-run
# log-likelihoods within MC_LOG_LIK_RTOL, resample picks within
# MAX_DIFFER); FastSLAM and mixed, MC_SIDE_RUNS runs x MC_SIDE_STEPS steps
# vmapped and sequential; the fill probe, JAX's default chunk (65536 //
# 256 = 256 runs) over the first MC_FILL_STEPS steps
RUN_SETS = 4
MC_FILL_PARTICLES = 65536
MC_STEP_RUNS, MC_STEP_AT, MC_LOG_LIK_RTOL = 8, 30, 1e-5
MC_SIDE_RUNS, MC_SIDE_STEPS = 4, 20
MC_FILL_STEPS = 50
# the island model (parallel/island.py): the dense step at ISLANDS
# islands, at thresholds that never and always exchange, ISLAND_ROUNDS
# rounds of (plain, both thresholds); the static runner
# over phase 3's run at RUNNER_ISLANDS islands, loop and scan; SYNC_RUNS
# runs stepped together with a mixed gate under the sync debug mode
ISLANDS, ISLAND_THRESHOLDS, RUNNER_ISLANDS = 8, (0.0, 1.1), 4
ISLAND_ROUNDS = 2
SYNC_RUNS = 4
# the mesh (phase 9d): MESH_STEPS dense steps held bit for bit; MESH_RANKS
# gloo ranks sharing the card; MESH_SIDE_STEPS steps of the other filters
MESH_STEPS, MESH_RANKS, MESH_SIDE_STEPS = 4, 2, 20
# the dense island step across those ranks, at these island counts, and
# the thresholds of the sharded and island steps: never, always
MESH_ISLANDS, MESH_THRESHOLDS = (4, 8), (0.0, 1.1)
# BASELINE config 5 (phase 9g; eval_baselines.py's config 5):
# cfg/ackerman_synth.cfg at CONFIG5's width over phase 3's run, run_scan
# over its first CONFIG5_STEPS steps, the plain comparisons CONFIG5_CHUNK
# particles at a time; over the mesh (phase 9d), the bytes received a step
# within CONFIG5_BYTES_TOL of the prediction
CONFIG5 = dict(P=65536, F=128, M=64)
CONFIG5_STEPS, CONFIG5_CHUNK, CONFIG5_BYTES_TOL = 16, 8192, 0.05
# F9's reading (phase 9d): CUMSUM_CALLS CUDA cumsums of the same weights
# at each size, one row and as the first of two rows
CUMSUM_SIZES, CUMSUM_CALLS = (8192, 32768, 65536, 262144), 100
# the dense sharded disparity step's steps (phase 9d); the constant-velocity
# card steps before the compared one (phase 9h)
MESH_DISP_STEPS, CV_STEPS = 3, 20
# the measuring entry points (phase 9e): the stage profile's stage count
# (10 at each of its 2 shapes, and the disparity step) and the kernels its
# stages launch
PROFILE_STAGES = 21
PROFILE_KERNELS = ("select", "select_by_index", "select4", "merge",
                   "merge4", "merge3", "esf", "preupdate")
# NVIDIA H100 SXM data sheet, at a 700 W power limit: float32 outside the
# tensor cores and HBM3 bandwidth
PEAK_F32_OPS, PEAK_BYTES = 67e12, 3.35e12
# the pre-update kernel (phase 2): the benchmark cells' shapes (timed)
# first, then odd ones (the scalar path); channels moved (6 in, 15 out);
# float32 operations an element: the predicted measurement and its wrap
# (12), the range classes (8), the Jacobian (8), S and its determinant
# (34), S^-1 (4), the gain (24), the Joseph form (53), the log (1); atan2,
# fmod, sqrt and log counted as one each
PREUPDATE_CASES = [(8192, 512), (65536, 128), (37, 129), (1, 5)]
PREUPDATE_TIMED = 2
PREUPDATE_CHANNELS, PREUPDATE_OPS = 21, 144
# float32 operations per (p, m, f) triple of the select loops: innovation
# (1), bearing wrap (4), quadratic form (9), clamp (1), exponent (2), exp
# (1), sum (1), gate (1); then one compare per argmax round, and 2 more
# to normalise and prune outside raw mode
SELECT_TRIPLE_OPS = 20
# float32 operations per candidate test of the merges: 2-D, the averaged
# covariance and its quadratic form; 4-D, the averaged covariance (20), the
# 4x4 Cholesky (4 sqrt, 6 divides, ~20 others), the triangular solve (4
# divides, ~12 others), the squared norm (7), the compares
MERGE_TEST_OPS, MERGE4_TEST_OPS = 24, 80
# float32 operations per gate test of merge.cu's gated chain: the offset,
# its squared length, the reach sum, its scale and the compare
MERGE_GATE_OPS = 8
# 3-D: the averaged covariance (12), determinant and adjugate (27), the
# quadratic form (15), the divide and the compares
MERGE3_TEST_OPS = 60
# one logaddexp of the ESF build-up: the add of ll_j, max, min, sub, exp,
# log1p, add; the exp and log1p counted as one operation each (the special
# function units run them at a quarter of this rate: an optimistic bound)
LAE_OPS = 7
KERNELS = (                         # name, source, the TPU kernel replaced
    ("preupdate", "phdslam_tpu_torch/csrc/preupdate.cu",
     "none: phdslam_tpu/filter/update.py:73 (kalman_preupdate, which XLA "
     "fuses; not a Pallas kernel)"),
    ("select", "phdslam_tpu_torch/csrc/select.cu",
     "phdslam_tpu/kernels/preupdate_pallas.py:274"),
    ("select_by_index", "phdslam_tpu_torch/csrc/select.cu",
     "phdslam_tpu/kernels/preupdate_pallas.py:368"),
    ("select4", "phdslam_tpu_torch/csrc/select4.cu",
     "phdslam_tpu/kernels/preupdate_pallas.py:605"),
    ("select4_by_index", "phdslam_tpu_torch/csrc/select4.cu",
     "phdslam_tpu/kernels/preupdate_pallas.py:493"),
    ("merge", "phdslam_tpu_torch/csrc/merge.cu",
     "phdslam_tpu/kernels/merge_pallas.py:331"),
    ("merge4", "phdslam_tpu_torch/csrc/merge4.cu",
     "phdslam_tpu/kernels/merge_pallas.py:546"),
    ("merge3", "phdslam_tpu_torch/csrc/merge3.cu",
     "phdslam_tpu/kernels/merge_pallas.py:685"),
    ("esf", "phdslam_tpu_torch/csrc/esf.cu",
     "phdslam_tpu/kernels/esf_pallas.py:85"),
    ("auction", "phdslam_tpu_torch/csrc/auction.cu",
     "phdslam_tpu/filter/fastslam.py:98 (_auction_rows whole: the clamp, "
     "the lax.while_loop and the readout; not a Pallas kernel)"),
    ("ospa_auction", "phdslam_tpu_torch/csrc/auction.cu",
     "phdslam_tpu/ops/ospa.py:74 (_auction_assign, lax.while_loop in a "
     "lax.scan over eps phases; not a Pallas kernel)"),
)


LOG_PREFIX = ""                      # a mesh rank's "[rank r/W] "


def log(msg):
    print(LOG_PREFIX + msg, flush=True)


def reset_peak_memory():
    """Start a phase's peak device memory from what it can reach: tensors
    an earlier phase left unreachable (in reference cycles) are freed
    first, or they count in this phase's peak."""
    import torch
    gc.collect()
    torch.cuda.reset_peak_memory_stats()


def cuda_ms(fn, reps, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _mods():
    from phdslam_tpu_torch.kernels import (esf, merge, merge3, merge4,
                                           select, select4)
    return select, select4, merge, merge4, merge3, esf


def _auction():
    from phdslam_tpu_torch.kernels import auction
    return auction


def _preupdate():
    from phdslam_tpu_torch.kernels import preupdate
    return preupdate


def launch_counts():
    """Every kernel's launch count, by the names of the JSON line."""
    S, S4, G, G4, G3, E = _mods()
    return dict(select=S.launches, select_by_index=S.launches_by_index,
                select4=S4.launches, select4_by_index=S4.launches_by_index,
                merge=G.launches, merge4=G4.launches, merge3=G3.launches,
                esf=E.launches, auction=_auction().launches,
                ospa_auction=_auction().launches_square,
                preupdate=_preupdate().launches)


def zero_launch_counts():
    S, S4, G, G4, G3, E = _mods()
    S.launches = S.launches_by_index = 0
    S4.launches = S4.launches_by_index = 0
    G.launches = G4.launches = G3.launches = E.launches = 0
    _auction().launches = _auction().launches_square = 0
    _preupdate().launches = 0


def bound_ms(n_bytes, n_ops):
    """The least time of the work on this card: bytes moved over the memory
    rate or float32 operations over the peak rate, the larger; returns
    (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_F32_OPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def bound(stats, name, n_bytes, n_ops):
    """bound_ms into stats[name] (bound_ms, bound_by)."""
    ms, by = bound_ms(n_bytes, n_ops)
    stats[name].update(bound_ms=ms, bound_by=by)


def _new_stats(stats, *names):
    for n in names:
        stats.setdefault(n, dict(max_abs_err=0.0))


def _err(stats, name, err):
    stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)


def compare_rows(kern, plain, live=None):
    """Per-particle agreement of output tensors (leading axis P) within
    rtol/atol, exactly for bool and integer outputs. live: optional mask
    per tensor of the entries to compare. Returns (particles that differ,
    max abs error over the others)."""
    import torch
    bad, errs = differing_rows(kern, plain, live)
    return int(bad.sum()), float(torch.where(bad, 0.0, errs).max())


def differing_rows(kern, plain, live=None):
    """compare_rows' per-particle masks: (differs [P], max abs error [P])."""
    import torch
    bad = errs = None
    for i, (k, p) in enumerate(zip(kern, plain)):
        if not k.is_floating_point():
            ok = k == p
            err = torch.zeros_like(k, dtype=torch.float32)
        else:
            ok = torch.isclose(k, p, rtol=RTOL, atol=ATOL)
            err = (k - p).abs()
        if live is not None and live[i] is not None:
            ok = ok | ~live[i]
            err = torch.where(live[i], err, 0.0)
        row_bad = ~ok.reshape(ok.shape[0], -1).all(1)
        row_err = err.reshape(err.shape[0], -1).amax(1)
        bad = row_bad if bad is None else bad | row_bad
        errs = row_err if errs is None else torch.maximum(errs, row_err)
    return bad, errs


def _limit(n_bad, P, what):
    if n_bad > MAX_DIFFER * P:
        raise RuntimeError(f"{what}: {n_bad} of {P} particles differ from "
                           f"the plain version (limit {MAX_DIFFER:.1%})")


def chunked(fn_kern, fn_plain, compare, args_of, P, chunk=DENSE_CHUNK):
    """Compare a kernel's outputs with its plain version chunk by chunk of
    particles (the plain [P, M, F] terms of a dense call need GiBs)."""
    kern = fn_kern(args_of(0, P))
    n_bad, worst = 0, 0.0
    for lo in range(0, P, chunk):
        plain = fn_plain(args_of(lo, lo + chunk))
        b, e = compare([k[lo:lo + chunk] for k in kern], plain)
        n_bad += b
        worst = max(worst, e)
    return kern, n_bad, worst


# --------------------------------------------------- phase 2: pre-update --

def _cases():
    """tests/preupdate_cases.py: the pre-update's inputs and its channel
    comparison, shared with the tests."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import preupdate_cases
    return preupdate_cases


def merge_pool(kind, P, K, seed, dev):
    """tests/merge_pools.py's pool of this kind, on dev."""
    import torch
    _cases()
    import merge_pools
    return [torch.as_tensor(a, device=dev)
            for a in merge_pools.POOLS[kind](P, K, seed)]


def phase_preupdate(dev, stats):
    """The pre-update kernel against its plain version on the same CUDA
    tensors at PREUPDATE_CASES, every channel bit for bit; at the
    benchmark cells' shapes (the first two) the kernel alone, its byte
    floor and the plain chain timed with CUDA events."""
    import torch
    from phdslam_tpu_torch.kernels import preupdate as K
    t0 = time.perf_counter()
    _new_stats(stats, "preupdate")
    times = []
    for i, (P, F) in enumerate(PREUPDATE_CASES):
        cfg, pose, gm = _cases().random_preupdate_inputs(P, F, P + F, dev)
        kern = K.preupdate_cuda(pose, gm, cfg)
        plain = K.preupdate_plain(pose, gm, cfg)
        torch.cuda.synchronize()
        bad = _cases().preupdate_channels_differing(kern, plain)
        classes = torch.bincount(kern.rclass.flatten(), minlength=3)
        log(f"preupdate [{P}, {F}]: range classes out / in / near "
            f"{classes.tolist()}, channels differing from plain "
            f"{bad or 'none'}")
        if bad:
            raise RuntimeError(f"preupdate [{P}, {F}]: channels differ from "
                               f"the plain chain (largest ulp gaps): {bad}")
        if i >= PREUPDATE_TIMED:
            continue
        ms = cuda_ms(lambda: K.preupdate_cuda(pose, gm, cfg), 20)
        plain_ms = cuda_ms(lambda: K.preupdate_plain(pose, gm, cfg), 5)
        b_ms, by = bound_ms(PREUPDATE_CHANNELS * 4 * P * F + 12 * P,
                            PREUPDATE_OPS * P * F)
        times.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=by))
        log(f"preupdate [{P}, {F}]: {ms:.4f} ms (plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms by {by}, {b_ms / ms:.1%} of it)")
    stats["preupdate"].update(library_ms=None, **times[0])
    log(f"phase preupdate: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------------ phase 2: select --

def random_select_inputs(P, F, M, seed, dev):
    """Kernel-1 inputs from kalman_preupdate on a seeded random map and
    measurement set (about half the slots live, features within 10 m)."""
    import torch
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.filter.state import Gaussian2DMixture
    from phdslam_tpu_torch.filter.update import kalman_preupdate

    rng = np.random.default_rng(seed)
    cfg = load_config(str(ROOT / "cfg/ackerman_synth.cfg")).replace(
        n_particles=P, maxFeatures=F, maxMeasurements=M)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    w = (rng.uniform(size=(P, F)) < 0.5) * rng.uniform(0.05, 1.0, (P, F))
    c00 = rng.uniform(0.1, 2.0, (P, F))
    c11 = rng.uniform(0.1, 2.0, (P, F))
    gm = Gaussian2DMixture(
        w=t(w), mx=t(rng.uniform(-2, 12, (P, F))),
        my=t(rng.uniform(-10, 10, (P, F))), c00=t(c00),
        c01=t(0.3 * np.sqrt(c00 * c11) * rng.uniform(-1, 1, (P, F))),
        c11=t(c11))
    pose = t(np.concatenate([rng.normal(0, 0.3, (P, 2)),
                             rng.normal(0, 0.05, (P, 1)),
                             np.zeros((P, 3))], axis=1))
    z = t(np.stack([rng.uniform(0.5, cfg.maxRange, M),
                    rng.uniform(-cfg.maxBearing, cfg.maxBearing, M)], 1))
    return cfg, kalman_preupdate(pose, gm, cfg), gm, z


def select_outputs_agree(kern, plain):
    """sum, 7 selection channels, compat: payload compared where the plain
    version picked a live (w > 0) term."""
    live_w = plain[1] > 0
    live = [None, None] + [live_w] * 6 + [None]
    return compare_rows(kern, plain, live)


def _select_args(S, cfg, pre, gm, z, case):
    import torch
    M = z.shape[0]
    nv = torch.tensor([case["nv"] or M], dtype=torch.int32, device=z.device)
    chans = [c.contiguous() for c in S.select_channels(pre, gm)]
    kw = dict(k1=K1, clutter_birth=float(cfg.clutterDensity
                                         + cfg.birthWeight),
              min_weight=float(cfg.minFeatureWeight),
              gate_threshold=float(cfg.gateThreshold), raw=case["raw"],
              with_compat=case["with_compat"], with_lpw=case["with_lpw"])
    return chans, kw, nv


def select_rows(w_sel, lpw, nv):
    """What the select loop's design rests on, from a launch's picks w_sel
    [P, M, k1] and its lpw channel [P, F] (the first nv columns): the share
    of rows whose argmax rounds exit early (fewer than k1 positive picks),
    the mean rounds a row runs (its positive picks, plus the one that finds
    the 0, at most k1) and the mean live (in-range) slots per particle."""
    import torch
    k1 = w_sel.shape[-1]
    n_pos = (w_sel[:, :nv] > 0).sum(-1)
    return (float((n_pos < k1).float().mean()),
            float(torch.clamp(n_pos + 1, max=k1).float().mean()),
            float((lpw > -5e29).sum(1).float().mean()))


def occupancy(fn, size, what):
    """Log a kernel's registers per thread and CTAs per SM from its C
    query fn(size, &regs)."""
    import ctypes
    regs = ctypes.c_int(0)
    ctas = fn(size, ctypes.byref(regs))
    if ctas < 1:
        raise RuntimeError(f"{what}: no CTA fits on an SM")
    log(f"{what}: {regs.value} registers per thread, {ctas} CTAs per SM")


def select_bytes(P, F, M, k1, by_index):
    n_in = S_LOOP if by_index else 16
    out = P * M * (4 + 1 + k1 * (8 if by_index else 7 * 4))
    return 4 * (n_in * P * F + 2 * M + 1) + out



def check_by_index(S, pre, gm, z, chans, nv, kw, pay, what):
    """The by-index kernel against its plain version, against the payload
    kernel's picks (pay), and the gather at its indices against the
    payload. Returns (particles differing, max abs error)."""
    from phdslam_tpu_torch.filter.update import gather_selected
    P = chans[0].shape[0]
    kwb = dict(kw, by_index=True)
    kern = S.select_cuda(chans[:S_LOOP], z, nv, **kwb)
    plain = S.select_plain(chans[:S_LOOP], z, nv, **kwb)
    n_bad, err = compare_rows(kern, plain)
    _limit(n_bad, P, f"select by index ({what})")
    n_pick, _ = compare_rows(kern[:2] + kern[3:], pay[:2] + pay[8:])
    if n_pick:
        raise RuntimeError(f"select by index ({what}): the picks of "
                           f"{n_pick} particles differ from the payload "
                           "kernel's")
    live = kern[1] > 0
    g = gather_selected(pre, gm, z, kern[2], with_lpw=False)[:5]
    n_gather, err_g = compare_rows(g, pay[2:7], [live] * 5)
    _limit(n_gather, P, f"gather at the by-index picks ({what})")
    log(f"select by index {what}: particles differing {n_bad}/{P} "
        f"(max_abs_err {err:.3e}); picks as the payload kernel's; gather "
        f"reproduces the payload, {n_gather} differing (max_abs_err "
        f"{err_g:.3e})")
    return n_bad, err


def phase_select(dev, stats):
    S = _mods()[0]
    t0 = time.perf_counter()
    _new_stats(stats, "select", "select_by_index")
    cases = [dict(raw=False, with_compat=True, with_lpw=True, nv=None),
             dict(raw=True, with_compat=False, with_lpw=False, nv=None),
             dict(raw=False, with_compat=True, with_lpw=True, nv=41)]
    P, F, M = SHIPPED["P"], SHIPPED["F"], SHIPPED["M"]
    cfg, pre, gm, z = random_select_inputs(P, F, M, 1, dev)
    for case in cases:
        chans, kw, nv = _select_args(S, cfg, pre, gm, z, case)
        kern = S.select_cuda(chans, z, nv, **kw)
        plain = S.select_plain(chans, z, nv, **kw)
        n_bad, err = select_outputs_agree(kern, plain)
        _err(stats, "select", err)
        log(f"select {P}x{F}x{M} raw={case['raw']} "
            f"compat={case['with_compat']} lpw={case['with_lpw']} "
            f"n_valid={int(nv)}: particles differing {n_bad}/{P}, "
            f"max_abs_err {err:.3e}")
        _limit(n_bad, P, "select (shipped shape)")
        _, err = check_by_index(S, pre, gm, z, chans, nv, kw, kern,
                                f"{P}x{F}x{M} raw={case['raw']} "
                                f"n_valid={int(nv)}")
        _err(stats, "select_by_index", err)

    from phdslam_tpu_torch.kernels import _build
    lib, _ = _build.library()
    for F_ in (SHIPPED["F"], DENSE["F"]):
        occupancy(lib.phd_select_ctas_per_sm, F_, f"select at F = {F_}")
    P, F, M = DENSE["P"], DENSE["F"], DENSE["M"]
    cfg, pre, gm, z = random_select_inputs(P, F, M, 2, dev)
    chans, kw, nv = _select_args(S, cfg, pre, gm, z, cases[0])
    kern, n_bad, err = chunked(
        lambda c: S.select_cuda(c, z, nv, **kw),
        lambda c: S.select_plain(c, z, nv, **kw), select_outputs_agree,
        lambda lo, hi: [c[lo:hi] for c in chans], P)
    _err(stats, "select", err)
    log(f"select {P}x{F}x{M} (chunks of {DENSE_CHUNK}): particles "
        f"differing {n_bad}/{P}, max_abs_err {err:.3e}")
    _limit(n_bad, P, "select (dense shape)")
    early, rounds, live = select_rows(kern[1], chans[2], M)
    log(f"select {P}x{F}x{M} normalised: rows exiting early {early:.4f}, "
        f"rounds per row {rounds:.3f} of {K1}, live slots per particle "
        f"{live:.1f} of {F}")
    _, err = check_by_index(S, pre, gm, z, chans, nv, kw, kern,
                            f"{P}x{F}x{M}")
    _err(stats, "select_by_index", err)

    kwb = dict(kw, by_index=True)
    loop = chans[:S_LOOP]
    for name, k_fn, p_fn, by in (
            ("select", lambda: S.select_cuda(chans, z, nv, **kw),
             lambda: S.select_plain(chans, z, nv, **kw), False),
            ("select_by_index", lambda: S.select_cuda(loop, z, nv, **kwb),
             lambda: S.select_plain(loop, z, nv, **kwb), True)):
        stats[name].update(ms=cuda_ms(k_fn, 10), plain_ms=cuda_ms(p_fn, 3),
                           library_ms=None)
        # normalised mode: 2 more operations per triple
        bound(stats, name, select_bytes(P, F, M, K1, by),
              P * M * F * (SELECT_TRIPLE_OPS + 2 + K1))
        s = stats[name]
        log(f"{name} timing {P}x{F}x{M}: {s['ms']:.4f} ms (plain "
            f"{s['plain_ms']:.3f} ms, bound {s['bound_ms']:.4f} ms by "
            f"{s['bound_by']})")
    log(f"phase select: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------------- phase 2: merge --

def random_pool(P, K, seed, dev):
    """A seeded candidate pool: ~60 % live weights, means in a 40 m box."""
    import torch
    rng = np.random.default_rng(seed)
    w = (rng.uniform(size=(P, K)) < 0.6) * rng.uniform(0.01, 2.0, (P, K))
    c00 = rng.uniform(0.05, 1.5, (P, K))
    c11 = rng.uniform(0.05, 1.5, (P, K))
    arrs = (w, rng.uniform(-20, 20, (P, K)), rng.uniform(-20, 20, (P, K)),
            c00, 0.3 * np.sqrt(c00 * c11) * rng.uniform(-1, 1, (P, K)), c11)
    return [torch.as_tensor(np.asarray(a, np.float32), device=dev)
            for a in arrs]


def candidate_tests(w, near, cap, exits=()):
    """The candidate tests the greedy merge of this pool makes: at each
    pick, one for every remaining live candidate of every particle still
    picking. near(pick [P, 1]) -> [P, K] bool is the merge's test; each of
    exits(pick) -> [P, K] bool marks the tests an early exit decides.
    Returns (tests, per exit the tests of a candidate other than the pick
    it decides)."""
    import torch
    w_rem = w.clone()
    col = torch.arange(w.shape[1], device=w.device)
    tests, decided = 0, [0] * len(exits)
    for _ in range(cap):
        pick = torch.argmax(w_rem, dim=1, keepdim=True)
        active = torch.gather(w_rem, 1, pick) > 0.0
        if not bool(active.any()):
            break
        live = w_rem > 0.0
        tests += int((live & active).sum())
        for e, ex in enumerate(exits):
            decided[e] += int((ex(pick) & live & active
                               & (col[None, :] != pick)).sum())
        sel = ((near(pick) & live) | (col[None, :] == pick)) & active
        w_rem = torch.where(sel, 0.0, w_rem)
    return tests, decided


def tie_weights(w, seed):
    """w with every live weight rounded to one of eight values: exact ties
    throughout, which the greedy order breaks by the lowest index."""
    import torch
    gen = torch.Generator(device=w.device).manual_seed(seed)
    q = torch.randint(1, 9, w.shape, generator=gen, device=w.device)
    return torch.where(w > 0, q.float() * 0.25, w)


def bit_identical(fn, what):
    """Two launches of fn on the same inputs give the same bits."""
    import torch
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise RuntimeError(f"{what}: two launches on the same inputs differ")
    log(f"{what}: two launches bit-identical")


def merge_tests(pool, sep, cap, metric):
    import torch
    G = _mods()[2]
    w, mx, my, c00, c01, c11 = pool

    def near(pick):
        take = lambda a: torch.gather(a, 1, pick)
        return G._near(metric, take(mx) - mx, take(my) - my, take(c00),
                       take(c01), take(c11), c00, c01, c11, sep)
    return candidate_tests(w, near, cap)[0]


def merge_cases(dev):
    """Every merge case of the merge phase: (name, pool, (min_sep, cap,
    metric)); random pools first, then tests/merge_pools.py's."""
    for i, (P, K, cap, metric, sep) in enumerate(MERGE_CASES + MERGE_TIES):
        pool = random_pool(P, K, 10 + i, dev)
        name = "random"
        if i >= len(MERGE_CASES):
            pool[0] = tie_weights(pool[0], i)
            name = "ties"
        yield name, pool, (sep, cap, metric)
    for i, (kind, P, K, cap, metric, sep) in enumerate(MERGE_POOL_CASES):
        yield kind, merge_pool(kind, P, K, 40 + i, dev), (sep, cap, metric)


def merge_ops(st):
    """float32 operations merge.cu's gated chain makes, from its counts
    (kernels/merge.py's STATS, [P, 6]): gate and exact tests."""
    G = _mods()[2]
    st = st.long()
    return (int(st[:, G.STATS.index("gate_tests")].sum()) * MERGE_GATE_OPS
            + int(st[:, G.STATS.index("exact_tests")].sum())
            * MERGE_TEST_OPS)


def gate_line(st, tests):
    """The merge kernel's chain counts (kernels/merge.py's STATS, [P, 6])
    as a dict and a log line; tests: the batched chain's candidate tests
    (pick_loop's, which merge.cu's gated chain replaces)."""
    G = _mods()[2]
    st = dict(zip(G.STATS, st.long().T))
    out = dict(exact_share=float(st["exact_tests"].sum()) / max(tests, 1),
               gate_share=float(st["gate_tests"].sum()) / max(tests, 1),
               batches_median=float(st["batches"].float().median()),
               batches_max=int(st["batches"].max()),
               unbounded_max=int(st["unbounded"].max()),
               live_median=float(st["live"].float().median()))
    text = (f"exact tests {out['exact_share']:.2%} of the chain's {tests} "
            f"(gate tests {out['gate_share']:.2%}), batches median "
            f"{out['batches_median']:.0f} max {out['batches_max']}, "
            f"unbounded max {out['unbounded_max']}, live median "
            f"{out['live_median']:.0f}")
    return out, text


def phase_merge(dev, stats):
    import torch
    from phdslam_tpu_torch.kernels import _build
    G = _mods()[2]
    t0 = time.perf_counter()
    _new_stats(stats, "merge")
    lib, _ = _build.library()
    for K in (MERGE_CASES[0][1], MERGE_CASES[1][1]):
        log(f"merge: {lib.phd_merge_ctas_per_sm(K)} CTAs per SM at K = {K}")
    stats["merge"]["gate"] = {}
    for i, (kind, pool, (sep, cap, metric)) in enumerate(merge_cases(dev)):
        P, K = pool[0].shape
        counts = torch.zeros((P, len(G.STATS)), dtype=torch.int32,
                             device=dev)
        kern = G.merge_cuda(*pool, sep, cap, metric, stats=counts)
        plain = G.merge_plain(*pool, sep, cap, metric)
        bad, errs = differing_rows(kern, plain)
        n_bad = int(bad.sum())
        err = float(errs[~bad].max()) if n_bad < P else 0.0
        _err(stats, "merge", err)
        if n_bad and kind == "finite_outliers":
            # degenerate covariances: rounding decides their near tests,
            # and float64 has to side with the kernel where it differs
            by_kern, _ = float64_sides(kern, plain, bad, G.merge_plain, pool,
                                       dict(min_separation=sep, max_out=cap,
                                            metric=metric))
            log(f"merge ({kind}): {n_bad}/{P} particles differ from the "
                f"plain version, float64 agrees with the kernel on "
                f"{by_kern}")
            n_bad -= by_kern
        tests = merge_tests(pool, sep, cap, metric)
        gate, text = gate_line(counts, tests)
        what = f"merge [{P}, {K}] -> {cap} metric {metric} ({kind})"
        stats["merge"]["gate"][what] = gate
        log(f"{what}: particles differing {n_bad}/{P}, max_abs_err "
            f"{err:.3e}, live slots {int((plain[0] > 0).sum(1).max())} max; "
            f"gate: {text}")
        _limit(n_bad, P, f"merge metric {metric} ({kind})")
        if kind not in ("random", "ties"):
            bit_identical(lambda: G.merge_cuda(*pool, sep, cap, metric),
                          what)
        if kind == "course":        # the cells' widths
            ms = cuda_ms(lambda: G.merge_cuda(*pool, sep, cap, metric), 5)
            log(f"{what}: {ms:.4f} ms")
        if i == 0:                  # the dense pool
            bit_identical(lambda: G.merge_cuda(*pool, sep, cap, metric),
                          f"merge [{P}, {K}] -> {cap}")
            s = stats["merge"]
            s.update(ms=cuda_ms(lambda: G.merge_cuda(*pool, sep, cap,
                                                     metric), 5),
                     plain_ms=cuda_ms(lambda: G.merge_plain(
                         *pool, sep, cap, metric), 2), library_ms=None)
            bound(stats, "merge", 4 * 6 * P * (K + cap), merge_ops(counts))
            log(f"merge timing [{P}, {K}] -> {cap}: {s['ms']:.3f} ms "
                f"(plain {s['plain_ms']:.3f} ms, bound {s['bound_ms']:.4f} "
                f"ms by {s['bound_by']}, the kernel's gate and exact tests; "
                f"the chain's {tests} candidate tests)")
    log(f"phase merge: ok ({time.perf_counter() - t0:.1f} s)")


# ----------------------------------------------------- phase 2: select4 --

def random_select4_inputs(P, F, M, seed, dev):
    """Kernel-3 inputs from kalman_preupdate4 on a seeded random dynamic map
    (about half the slots live, positions within 10 m, velocities ~0.5 m/s,
    random positive definite 4x4 covariances)."""
    import torch
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.filter.state import Gaussian4DMixture
    from phdslam_tpu_torch.filter.update4 import kalman_preupdate4

    rng = np.random.default_rng(seed)
    cfg = load_config(str(ROOT / "cfg/mixed_synth.cfg")).replace(
        n_particles=P, maxFeatures=F, maxMeasurements=M)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    gm = Gaussian4DMixture(
        w=t((rng.uniform(size=(P, F)) < 0.5)
            * rng.uniform(0.05, 1.0, (P, F))),
        mean_channels=t(np.concatenate(
            [rng.uniform(-2, 12, (P, 1, F)), rng.uniform(-10, 10, (P, 1, F)),
             rng.normal(0, 0.5, (P, 2, F))], 1)),
        cov_channels=t(random_cov4(rng, (P, F))))
    pose = t(np.concatenate([rng.normal(0, 0.3, (P, 2)),
                             rng.normal(0, 0.05, (P, 1)),
                             np.zeros((P, 3))], axis=1))
    z = t(np.stack([rng.uniform(0.5, cfg.maxRange, M),
                    rng.uniform(-cfg.maxBearing, cfg.maxBearing, M)], 1))
    return kalman_preupdate4(pose, gm, cfg), gm, z


def random_cov4(rng, shape, scale=0.5, floor=0.2):
    """[..., 10, F] channels (S4 order) of random positive definite 4x4s;
    shape = (..., F). Built channel by channel from a random factor, to
    stay light at the dense shapes."""
    a = rng.normal(size=(4, 4) + shape).astype(np.float32) * scale
    return np.stack([(a[i] * a[j]).sum(0) + (floor if i == j else 0.0)
                     for i in range(4) for j in range(i, 4)],
                    axis=-2).astype(np.float32)


def select4_outputs_agree(kern, plain):
    """sum, w, mean, cov: payload compared where the plain version picked a
    live (w > 0) term."""
    live = plain[1] > 0
    return compare_rows(kern, plain, [None, None, live[:, None],
                                      live[:, None]])


def select4_bytes(P, F, M, k1, by_index):
    n_in = S_LOOP if by_index else 29
    out = P * M * (4 + k1 * (8 if by_index else 15 * 4))
    return 4 * (n_in * P * F + 2 * M) + out


def phase_select4(dev, stats):
    from phdslam_tpu_torch.filter.update4 import gather_selected4
    S4 = _mods()[1]
    t0 = time.perf_counter()
    _new_stats(stats, "select4", "select4_by_index")
    from phdslam_tpu_torch.kernels import _build
    lib, _ = _build.library()
    for F_ in (SHIPPED["F"], DENSE["F"]):
        occupancy(lib.phd_select4_ctas_per_sm, F_, f"select4 at F = {F_}")
    for i, shape in enumerate((SHIPPED, ODD, DENSE)):
        P, F, M = shape["P"], shape["F"], shape["M"]
        pre4, gm4, z = random_select4_inputs(P, F, M, 20 + i, dev)
        loop, gain, mean, cov = S4.select4_channels(pre4, gm4)
        loop = [c.contiguous() for c in loop]
        sl = lambda lo, hi: ([c[lo:hi] for c in loop], gain[lo:hi],
                             mean[lo:hi], cov[lo:hi])
        kern, n_bad, err = chunked(
            lambda a: S4.select4_cuda(*a, z, k1=K1),
            lambda a: S4.select4_plain(*a, z, k1=K1),
            select4_outputs_agree, sl, P)
        _err(stats, "select4", err)
        _limit(n_bad, P, f"select4 {P}x{F}x{M}")
        idx, n_bad_i, err_i = chunked(
            lambda a: S4.select4_cuda(a[0], None, None, None, z, k1=K1,
                                      by_index=True),
            lambda a: S4.select4_plain(a[0], None, None, None, z, k1=K1,
                                       by_index=True),
            compare_rows, sl, P)
        _err(stats, "select4_by_index", err_i)
        _limit(n_bad_i, P, f"select4 by index {P}x{F}x{M}")
        n_pick, _ = compare_rows(idx[:2], kern[:2])
        if n_pick:
            raise RuntimeError(f"select4 by index {P}x{F}x{M}: the picks "
                               f"of {n_pick} particles differ from the "
                               "payload kernel's")
        live = kern[1] > 0
        g_mean, g_cov = gather_selected4(pre4, gm4, z, idx[2])
        n_gather, err_g = compare_rows((g_mean, g_cov), kern[2:],
                                       [live[:, None]] * 2)
        _limit(n_gather, P, f"gather4 at the by-index picks {P}x{F}x{M}")
        log(f"select4 {P}x{F}x{M} k1={K1}: particles differing "
            f"{n_bad}/{P} (max_abs_err {err:.3e}); by index {n_bad_i}/{P} "
            f"(max_abs_err {err_i:.3e}), picks as the payload kernel's, "
            f"gather reproduces the payload ({n_gather} differing, "
            f"max_abs_err {err_g:.3e}); live picks {float(live.float().mean()):.3f}")
    early, rounds, nlive = select_rows(kern[1], loop[2], M)
    log(f"select4 {P}x{F}x{M} raw: rows exiting early {early:.4f}, rounds "
        f"per row {rounds:.3f} of {K1}, live slots per particle "
        f"{nlive:.1f} of {F}")
    a = ([c for c in loop], gain, mean, cov)
    for name, k_fn, p_fn, by in (
            ("select4", lambda: S4.select4_cuda(*a, z, k1=K1),
             lambda: S4.select4_plain(*a, z, k1=K1), False),
            ("select4_by_index",
             lambda: S4.select4_cuda(loop, None, None, None, z, k1=K1,
                                     by_index=True),
             lambda: S4.select4_plain(loop, None, None, None, z, k1=K1,
                                      by_index=True), True)):
        stats[name].update(ms=cuda_ms(k_fn, 10), plain_ms=cuda_ms(p_fn, 3),
                           library_ms=None)
        bound(stats, name, select4_bytes(P, F, M, K1, by),
              P * M * F * (SELECT_TRIPLE_OPS + K1))
        s = stats[name]
        log(f"{name} timing {P}x{F}x{M}: {s['ms']:.4f} ms (plain "
            f"{s['plain_ms']:.3f} ms, bound {s['bound_ms']:.4f} ms by "
            f"{s['bound_by']})")
    log(f"phase select4: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------ phase 2: per-run measurement sets --

def run_sets(R, M, cfg, seed, dev):
    """R seeded measurement sets [R, M, 2] over the sensor's range."""
    import torch
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.stack(
        [rng.uniform(0.5, cfg.maxRange, (R, M)),
         rng.uniform(-cfg.maxBearing, cfg.maxBearing, (R, M))],
        -1).astype(np.float32), device=dev)


def phase_select_runs(dev, stats):
    """select and select4, both modes, on RUN_SETS runs of the shipped
    shape blockwise, each run with its own measurement set (select: and
    its own n_valid): one launch against RUN_SETS single-run launches on
    the particle slices, bit for bit, and against the plain version on the
    same per-run inputs."""
    import torch
    S, S4 = _mods()[:2]
    t0 = time.perf_counter()
    R = RUN_SETS
    n, F, M = SHIPPED["P"], SHIPPED["F"], SHIPPED["M"]
    P = R * n
    cfg, pre, gm, z1 = random_select_inputs(P, F, M, 31, dev)
    z = run_sets(R, M, cfg, 32, dev)
    nv = torch.tensor([M, 41, M, 7][:R], dtype=torch.int32, device=dev)
    pre4, gm4, _ = random_select4_inputs(P, F, M, 33, dev)
    loop4, gain, mean, cov = S4.select4_channels(pre4, gm4)
    loop4 = [c.contiguous() for c in loop4]
    pay4 = [gain.contiguous(), mean.contiguous(), cov.contiguous()]
    cut = lambda xs, sl: [x[sl] for x in xs]
    cases = []
    for raw in (False, True):
        chans, kw, _ = _select_args(S, cfg, pre, gm, z1, dict(
            raw=raw, with_compat=not raw, with_lpw=not raw, nv=None))
        kwb = dict(kw, by_index=True)
        cases += [
            (f"select raw={raw}", "select", S.select_cuda, S.select_plain,
             lambda zz, v, sl, c=chans: (cut(c, sl), zz, v), kw,
             select_outputs_agree),
            (f"select by index raw={raw}", "select_by_index", S.select_cuda,
             S.select_plain,
             lambda zz, v, sl, c=chans: (cut(c[:S_LOOP], sl), zz, v), kwb,
             compare_rows)]
    cases += [
        ("select4", "select4", S4.select4_cuda, S4.select4_plain,
         lambda zz, v, sl: (cut(loop4, sl), *cut(pay4, sl), zz),
         dict(k1=K1), select4_outputs_agree),
        ("select4 by index", "select4_by_index", S4.select4_cuda,
         S4.select4_plain,
         lambda zz, v, sl: (cut(loop4, sl), None, None, None, zz),
         dict(k1=K1, by_index=True), compare_rows)]
    for what, key, kern_fn, plain_fn, args, kw, agree in cases:
        zero_launch_counts()
        got = kern_fn(*args(z, nv, slice(None)), **kw)
        launched = sum(launch_counts().values())
        if launched != 1:
            raise RuntimeError(f"{what} with {R} run sets: {launched} "
                               "launches, expected 1")
        n_diff = 0
        for r in range(R):
            sl = slice(r * n, (r + 1) * n)
            one = kern_fn(*args(z[r].contiguous(), nv[r:r + 1].contiguous(),
                                sl), **kw)
            same = torch.ones(n, dtype=torch.bool, device=dev)
            for g, o in zip(got, one):
                same &= (g[sl] == o).reshape(n, -1).all(1)
            n_diff += int((~same).sum())
        if n_diff:
            raise RuntimeError(f"{what} with {R} run sets: {n_diff} of {P} "
                               "particles differ from the single-run "
                               "launches")
        n_bad, err = agree(got, plain_fn(*args(z, nv, slice(None)), **kw))
        _limit(n_bad, P, f"{what} with {R} run sets")
        _err(stats, key, err)
        log(f"{what} {R} runs x {n}x{F}x{M}: bit for bit as {R} single-run "
            f"launches; against plain {n_bad}/{P} particles differing "
            f"(max_abs_err {err:.3e})")
    log(f"phase run sets: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------------ phase 2: merge4 --

def random_pool4(P, K, seed, dev):
    """A seeded 4-D candidate pool: ~60 % live weights, positions in a
    20 m box, velocities ~0.5 m/s, random positive definite covariances."""
    import torch
    rng = np.random.default_rng(seed)
    w = (rng.uniform(size=(P, K)) < 0.6) * rng.uniform(0.01, 2.0, (P, K))
    mean = np.concatenate([rng.uniform(-10, 10, (P, 2, K)),
                           rng.normal(0, 0.5, (P, 2, K))], 1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return t(w), t(mean), t(random_cov4(rng, (P, K)))


def merge4_tests(pool, sep, cap):
    """(candidate tests, tests the kernel's division-free first-pivot test
    rejects, tests the first two pivots reject: y0^2 + y1^2 >= min_sep)."""
    import torch
    from phdslam_tpu_torch.ops.linalg import chol4_quad
    w, mean, cov = pool
    k0 = _mods()[3].reject_scale(sep)

    def terms(pick):
        take = lambda a: torch.gather(a, 1, pick)
        a = [0.5 * (take(cov[:, q]) + cov[:, q]) for q in range(10)]
        d = [take(mean[:, k]) - mean[:, k] for k in range(4)]
        return a, d

    def near(pick):
        return chol4_quad(*terms(pick)) < sep

    def first(pick):
        a, d = terms(pick)
        return d[0].double() ** 2 > k0 * torch.clamp(a[0], min=1e-12).double()

    def two(pick):
        a, d = terms(pick)
        l00 = torch.sqrt(torch.clamp(a[0], min=1e-12))
        l10 = a[1] / l00
        l11 = torch.sqrt(torch.clamp(a[4] - l10 * l10, min=1e-12))
        y0 = d[0] / l00
        y1 = (d[1] - l10 * y0) / l11
        return y0 * y0 + y1 * y1 >= sep
    tests, (n_first, n_two) = candidate_tests(w, near, cap, (first, two))
    return tests, n_first, n_two


def degenerate_pool4(P, K, seed, dev):
    """A 4-D pool whose covariances make the clamped Cholesky bind: a
    quarter zero, a quarter singular (rank 1), a quarter slightly
    indefinite (rank 1 minus 1e-3 on the diagonal), a quarter random
    positive definite; positions in a 6 m box, so that many candidates pass
    the early exit and reach the full test."""
    import torch
    rng = np.random.default_rng(seed)
    w = (rng.uniform(size=(P, K)) < 0.6) * rng.uniform(0.01, 2.0, (P, K))
    mean = np.concatenate([rng.uniform(-3, 3, (P, 2, K)),
                           rng.normal(0, 0.5, (P, 2, K))], 1)
    cov = random_cov4(rng, (P, K))
    u = rng.normal(size=(4, P, K)).astype(np.float32)
    rank1 = np.stack([u[i] * u[j] for i in range(4) for j in range(i, 4)], 1)
    kind = rng.integers(0, 4, (P, 1, K))
    diag = np.zeros((1, 10, 1), np.float32)
    diag[0, [0, 4, 7, 9], 0] = 1e-3
    cov = np.where(kind == 0, 0.0, np.where(kind == 1, rank1, np.where(
        kind == 2, rank1 - diag, cov)))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return t(w), t(mean), t(cov)


def phase_merge4(dev, stats):
    from phdslam_tpu_torch.kernels import _build
    G4 = _mods()[3]
    t0 = time.perf_counter()
    _new_stats(stats, "merge4")
    lib, _ = _build.library()
    log(f"merge4: {lib.phd_merge4_ctas_per_sm(MERGE4_CASES[0][1])} CTAs "
        f"per SM at K = {MERGE4_CASES[0][1]}")
    cases = [(c, "random") for c in MERGE4_CASES] \
        + [(c, "tie") for c in MERGE4_TIES] \
        + [(c, "degenerate") for c in MERGE4_DEGENERATE]
    for i, ((P, K, cap, sep), kind) in enumerate(cases):
        if kind == "degenerate":
            pool = degenerate_pool4(P, K, 30 + i, dev)
        else:
            pool = random_pool4(P, K, 30 + i, dev)
        if kind == "tie":
            pool = (tie_weights(pool[0], i),) + tuple(pool[1:])
        kern = G4.merge4_cuda(*pool, sep, cap)
        plain = G4.merge4_plain(*pool, sep, cap)
        n_bad, err = compare_rows(kern, plain)
        _err(stats, "merge4", err)
        log(f"merge4 {kind} [{P}, {K}] -> {cap} min_sep {sep}: particles "
            f"differing {n_bad}/{P}, max_abs_err {err:.3e}, live slots "
            f"{int((plain[0] > 0).sum(1).max())} max")
        _limit(n_bad, P, f"merge4 {kind} min_sep {sep}")
        if i in (0, 2) or kind == "degenerate":
            tests, n_first, n_two = merge4_tests(pool, sep, cap)
            log(f"merge4 {kind} [{P}, {K}] -> {cap} min_sep {sep}: {tests} "
                f"candidate tests; the early exits decide {n_two} "
                f"({n_two / tests:.1%}) on the first two pivots, {n_first} "
                f"({n_first / tests:.1%}) of them on the first alone, "
                "without a division")
        if i == 0:                  # the dense pool at the shipped gate
            bit_identical(lambda: G4.merge4_cuda(*pool, sep, cap),
                          f"merge4 [{P}, {K}] -> {cap}")
            s = stats["merge4"]
            s.update(ms=cuda_ms(lambda: G4.merge4_cuda(*pool, sep, cap), 5),
                     plain_ms=cuda_ms(lambda: G4.merge4_plain(*pool, sep,
                                                              cap), 2),
                     library_ms=None)
            bound(stats, "merge4", 4 * 15 * P * (K + cap),
                  tests * MERGE4_TEST_OPS)
            log(f"merge4 timing [{P}, {K}] -> {cap}: {s['ms']:.3f} ms "
                f"(plain {s['plain_ms']:.3f} ms, bound {s['bound_ms']:.4f} "
                f"ms by {s['bound_by']}, {tests} candidate tests)")
    log(f"phase merge4: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------------ phase 2: merge3 --

def random_pool3(P, K, seed, dev):
    """A seeded disparity-space pool: ~60 % live weights, (u, v) in a
    100-pixel box and d in [50, 300] (so that neighbours merge at min_sep
    4), random positive definite covariances of a few pixels."""
    import torch
    from phdslam_tpu_torch.kernels.merge3 import PAIRS
    rng = np.random.default_rng(seed)
    w = (rng.uniform(size=(P, K)) < 0.6) * rng.uniform(0.01, 2.0, (P, K))
    a = rng.normal(size=(3, 3, P, K)).astype(np.float32) \
        * np.array([4.0, 4.0, 20.0], np.float32)[:, None, None, None]
    cov = [(a[i] * a[j]).sum(0) + (np.array([4.0, 4.0, 25.0])[i]
                                   if i == j else 0.0) for i, j in PAIRS]
    arrs = [w, rng.uniform(300, 400, (P, K)), rng.uniform(200, 300, (P, K)),
            rng.uniform(50, 300, (P, K))] + cov
    return [torch.as_tensor(np.asarray(x, np.float32), device=dev)
            for x in arrs]


def merge3_tests(pool, sep, cap):
    import torch
    from phdslam_tpu_torch.kernels.merge3 import mahalanobis3
    w, means, covs = pool[0], pool[1:4], pool[4:]

    def near(pick):
        take = lambda a: torch.gather(a, 1, pick)
        return mahalanobis3([0.5 * (take(c) + c) for c in covs],
                            [take(m) - m for m in means]) < sep
    return candidate_tests(w, near, cap)[0]


def phase_merge3(dev, stats):
    G3 = _mods()[4]
    t0 = time.perf_counter()
    _new_stats(stats, "merge3")
    from phdslam_tpu_torch.kernels import _build
    lib, _ = _build.library()
    occupancy(lib.phd_merge3_ctas_per_sm, MERGE3_CASES[0][1],
              f"merge3 at K = {MERGE3_CASES[0][1]}")
    for i, (P, K, cap, sep) in enumerate(MERGE3_CASES):
        pool = random_pool3(P, K, 40 + i, dev)
        kern = G3.merge3_cuda(*pool, sep, cap)
        plain = G3.merge3_plain(*pool, sep, cap)
        n_bad, err = compare_rows(kern, plain)
        _err(stats, "merge3", err)
        _limit(n_bad, P, f"merge3 [{P}, {K}] -> {cap}")
        case = dict(ms=cuda_ms(lambda: G3.merge3_cuda(*pool, sep, cap), 5),
                    plain_ms=cuda_ms(lambda: G3.merge3_plain(*pool, sep,
                                                             cap), 2),
                    library_ms=None)
        tests = merge3_tests(pool, sep, cap)
        one = {"merge3": case}
        bound(one, "merge3", 4 * 10 * P * (K + cap), tests * MERGE3_TEST_OPS)
        log(f"merge3 [{P}, {K}] -> {cap} min_sep {sep}: particles differing "
            f"{n_bad}/{P}, max_abs_err {err:.3e}, live slots "
            f"{int((plain[0] > 0).sum(1).max())} max; {case['ms']:.4f} ms "
            f"(plain {case['plain_ms']:.3f} ms, bound {case['bound_ms']:.4f}"
            f" ms by {case['bound_by']}, {tests} candidate tests)")
        if i == 0:                  # the dense pool goes to the JSON line
            if n_bad:
                bad, _ = differing_rows(kern, plain)
                by_kern, by_plain = float64_sides(
                    kern, plain, bad, G3.merge3_plain, pool, dict(
                        min_separation=sep, max_out=cap))
                n_w, _ = compare_rows([kern[0][bad]], [plain[0][bad]])
                log(f"merge3 [{P}, {K}] -> {cap}: of the {n_bad} particles "
                    f"differing, {n_w} in a slot weight; the plain version "
                    f"in float64 agrees with the kernel on {by_kern} and "
                    f"with the float32 plain version on {by_plain}")
            bit_identical(lambda: G3.merge3_cuda(*pool, sep, cap),
                          f"merge3 [{P}, {K}] -> {cap}")
            stats["merge3"].update(case)
    log(f"phase merge3: ok ({time.perf_counter() - t0:.1f} s)")


# --------------------------------------------------------- phase 2: esf --

def esf_agree(kern, plain):
    """(esf, esfd) per particle: entries finite in either version within
    rtol/atol (so a sentinel, below -1e29, in one version only, or a NaN,
    makes its particle differ); entries that are the sentinel in both are
    not compared. Returns (particles that differ, max abs error over the
    others)."""
    import torch
    live = [(p > -1e29) | (k > -1e29) | torch.isnan(k)
            for k, p in zip(kern, plain)]
    return compare_rows(kern, plain, live)


def esf_logaddexps(ll):
    """The logaddexps the ESF build-up needs on these inputs: with n live
    (finite) measurements, the full set takes n (n + 1) / 2 coefficient
    updates and each of the n sets with a live measurement deleted
    (n - 1) n / 2; a deleted padded slot's set is the full one."""
    n = (ll > -1e30).sum(1).double()
    return int((n * (n - 1) * n / 2 + n * (n + 1) / 2).sum())


def esf_exact(kern, plain, what):
    """The esf kernel matches its plain version bit for bit (it runs the
    same operations on the same operands)."""
    import torch
    if not all(torch.equal(k, p) for k, p in zip(kern, plain)):
        raise RuntimeError(f"esf ({what}): not bit-identical to the plain "
                           "version")


def phase_esf(dev, stats):
    import torch
    from phdslam_tpu_torch.kernels import _build
    E = _mods()[5]
    t0 = time.perf_counter()
    _new_stats(stats, "esf")
    lib, _ = _build.library()
    for P_, M_ in ((1024, 64), (256, 64), (1024, 128), (64, 256)):
        occupancy(functools.partial(lib.phd_esf_ctas_per_sm, P_), M_,
                  f"esf lanes at [{P_}, {M_}]")
    n_mis = lib.phd_esf_log1p_mismatches()
    log(f"esf log1p_nonneg against the library's log1pf on every float in "
        f"[0, inf): {n_mis} differing")
    if n_mis != 0:
        raise RuntimeError("esf: log1p_nonneg is not log1pf bit for bit")
    for i, (P, M, pad) in enumerate(ESF_CASES):
        rng = np.random.default_rng(50 + i)
        # log Lambda_m as the CPHD update makes them: log detection mass +
        # log(clutter rate / clutter density), a few units around 0
        ll = rng.normal(-1.0, 2.0, (P, M)).astype(np.float32)
        if pad > 0:
            ll[:, M - pad:] = -np.inf
        elif pad == -1:
            ll[rng.uniform(size=(P, M)) < 0.3] = -np.inf
        elif pad == -2:
            ll[::2] = -np.inf
        ll = torch.as_tensor(ll, device=dev)
        kern = E.esf_all_cuda(ll)
        plain = E.esf_all_plain(ll)
        n_bad, err = esf_agree(kern, plain)
        _err(stats, "esf", err)
        _limit(n_bad, P, f"esf [{P}, {M}]")
        esf_exact(kern, plain, f"[{P}, {M}] n_pad {pad}")
        case = dict(ms=cuda_ms(lambda: E.esf_all_cuda(ll), 10),
                    plain_ms=cuda_ms(lambda: E.esf_all_plain(ll), 3),
                    library_ms=None)
        n_lae = esf_logaddexps(ll)
        one = {"esf": case}
        bound(one, "esf", 4 * P * (M + (M + 1) + M * M), n_lae * LAE_OPS)
        log(f"esf [{P}, {M}] (n_pad {pad}): bit-identical to plain; "
            f"{case['ms']:.4f} ms "
            f"(plain {case['plain_ms']:.3f} ms, bound {case['bound_ms']:.4f}"
            f" ms by {case['bound_by']}, {n_lae} logaddexps)")
        if i == 0:                  # the dense CPHD shape goes to the JSON
            stats["esf"].update(case)
    log(f"phase esf: ok ({time.perf_counter() - t0:.1f} s)")


# ----------------------------------------------------- phase 2: auction --

def random_auction_inputs(P, M, F, seed, dev, kind=""):
    """FastSLAM's raw benefit on seeded values (F feature columns, 60 % of
    the pairs gated out at NEG) and a private value (log kappa of
    cfg/fastslam_synth.cfg's order); kind "gated": every other particle
    has no live pair; "nan": NaN entries in 5 particles (not live: clamped
    to the floor). Returns (benefit [P, M, F], pv, budget)."""
    import torch
    from phdslam_tpu_torch.filter import fastslam as FS
    rng = np.random.default_rng(seed)
    ben = rng.normal(-3.0, 3.0, (P, M, F)).astype(np.float32)
    ben[rng.uniform(size=(P, M, F)) < 0.6] = FS._NEG
    if kind == "gated":
        ben[::2] = FS._NEG
    if kind == "nan":
        ben[1, 3, 7] = np.nan
        ben[4] = np.nan
        ben[5, :, 50] = np.nan
        ben[9, 0, :] = np.nan
        ben[100, 63, F - 1] = np.nan
    budget = FS._BIDS_PER_ROW * (F + M)
    if kind.startswith("budget "):
        budget = int(kind.split()[1])
    return (torch.as_tensor(ben, device=dev).contiguous(),
            float(rng.normal(-4.0, 1.0)), budget)


def auction_exact(kern, plain, n_cols, what):
    """The auction kernel's (col, iters) equal the plain version's bit for
    bit, every column in [0, n_cols). Returns (particles that differ, max
    abs error): (0, 0.0)."""
    bad, _ = differing_rows(kern, plain)
    if int(bad.sum()) or int(kern[0].min()) < 0 \
            or int(kern[0].max()) >= n_cols:
        raise RuntimeError(f"auction ({what}): {int(bad.sum())} particles "
                           "differ from the plain version, or a column is "
                           "out of range")
    return 0, 0.0


def auction_rounds(iters, budget):
    """(mean, max, particles at the budget) of a launch's rounds."""
    return (float(iters.float().mean()), int(iters.max()),
            int((iters >= budget).sum()))


def auction_bound(stats, name, P, M, F, iters):
    """The raw benefit read once and the columns and rounds written, over
    the memory rate; AUCTION_OPS per (round, row, column) of the rounds
    run, over the float32 rate."""
    bound(stats, name, 4 * P * (M * F + M + 1),
          int(iters.long().sum()) * M * (F + M) * AUCTION_OPS)


def phase_auction(dev, stats):
    import ctypes
    from phdslam_tpu_torch.kernels import _build
    A = _auction()
    t0 = time.perf_counter()
    _new_stats(stats, "auction")
    lib, _ = _build.library()
    regs = ctypes.c_int(0)
    for M_, C_ in ((64, 192), (64, 576), (64, 20000)):
        ctas = lib.phd_auction_ctas_per_sm(M_, C_, ctypes.byref(regs))
        log(f"auction at M = {M_}, C = {C_}: path "
            f"{lib.phd_auction_path(M_, C_)} (1 the state in shared memory, "
            f"0 in device memory), {regs.value} registers, {ctas} CTAs per "
            "SM")
        if ctas <= 0:
            raise RuntimeError("auction: the occupancy query failed")
    for i, (P, M, F, kind) in enumerate(AUCTION_CASES):
        ben, pv, budget = random_auction_inputs(P, M, F, 80 + i, dev, kind)
        kern = A.auction_assign_cuda(ben, pv, budget)
        auction_exact(kern, A.auction_assign_plain(ben, pv, budget), F + M,
                      f"[{P}, {M}, {F}] {kind}")
        bit_identical(lambda: A.auction_assign_cuda(ben, pv, budget),
                      f"auction [{P}, {M}, {F}]")
        case = dict(ms=cuda_ms(lambda: A.auction_assign_cuda(ben, pv,
                                                              budget), 10),
                    plain_ms=cuda_ms(lambda: A.auction_assign_plain(
                        ben, pv, budget), 1),
                    library_ms=None)
        one = {"auction": case}
        auction_bound(one, "auction", P, M, F, kern[1])
        mean_it, max_it, at_budget = auction_rounds(kern[1], budget)
        log(f"auction [{P}, {M}, {F}] {kind or 'random'}: bit-identical to "
            f"plain (columns and rounds); rounds per particle mean "
            f"{mean_it:.2f} max {max_it}, {at_budget} at the budget {budget};"
            f" {case['ms']:.4f} ms (plain {case['plain_ms']:.3f} ms, bound "
            f"{case['bound_ms']:.4f} ms by {case['bound_by']})")
        if kind.startswith("budget") and (at_budget == 0
                                          or max_it != budget):
            raise RuntimeError("auction: no particle ran to the budget of "
                               f"{budget} rounds")
        if kind == "gated" and int(kern[1][::2].max()) != 1:
            raise RuntimeError("auction: all-gated particles took more "
                               "than one round")
        if i == 0:                  # the dense shape goes to the JSON
            stats["auction"].update(case)
    log(f"phase auction: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------ phase 2: OSPA auction --

def ospa_sets(n, seed, dev):
    """scripts/ospa_latency.py's random set pair at size n: each set half
    to fully real, points N(0, 8). Returns (numpy x, y, m_x, m_y, and the
    padded tensors x, x_valid, y, y_valid on dev)."""
    import torch
    r = np.random.default_rng(seed)
    m_x = int(r.integers(n // 2, n + 1))
    m_y = int(r.integers(n // 2, n + 1))
    x = r.normal(0, 8, (n, 2)).astype(np.float32)
    y = r.normal(0, 8, (n, 2)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)
    return x, y, m_x, m_y, (t(x), t(np.arange(n) < m_x), t(y),
                            t(np.arange(n) < m_y))


def square_exact(kern, plain, what):
    """The square auction kernel's (owner, iters) equal the plain
    version's bit for bit, every column owned by exactly one row."""
    import torch
    n = kern[0].shape[1]
    perm = (kern[0].sort(1).values
            == torch.arange(n, device=kern[0].device)).all()
    if not (torch.equal(kern[0], plain[0]) and torch.equal(kern[1], plain[1])
            and bool(perm)):
        raise RuntimeError(f"square auction ({what}): the kernel's owners or "
                           "rounds differ from the plain version's, or the "
                           "owners are not a permutation")


def phase_ospa(dev, stats):
    """The square OSPA auction against its plain version, bit for bit, at
    each OSPA size on 8 set pairs (one launch, a CTA each) and with
    OSPA_BUDGET rounds a phase, timed beside its bound; then the entry
    point ospa_torch on every pair, its launches counted, against
    ospa_np."""
    import ctypes

    import torch
    from phdslam_tpu_torch.kernels import _build
    from phdslam_tpu_torch.ops import ospa as O
    from phdslam_tpu_torch.ops.ospa import ospa_np
    A = _auction()
    regs = ctypes.c_int(0)
    t0 = time.perf_counter()
    _new_stats(stats, "ospa_auction")
    lib, _ = _build.library()
    eps = O.eps_schedule(dev)
    K = eps.shape[0]
    pairs = {n: [ospa_sets(n, s, dev) for s in range(OSPA_SEEDS)]
             for n in OSPA_SIZES}
    for n in OSPA_SIZES:
        cost = torch.stack([O.padded_cost(*pr[4], OSPA_P, OSPA_C)[1]
                            for pr in pairs[n]]).contiguous()
        budget = O._BIDS_PER_N * n
        kern = A.auction_square_cuda(cost, eps, budget)
        owner_p, iters_p, bids = A.square_plain_with_bids(cost, eps, budget)
        square_exact(kern, (owner_p, iters_p), f"n = {n}")
        bit_identical(lambda: A.auction_square_cuda(cost, eps, budget),
                      f"square auction [{OSPA_SEEDS}, {n}, {n}]")
        case = dict(ms=cuda_ms(lambda: A.auction_square_cuda(cost, eps,
                                                              budget), 10),
                    plain_ms=cuda_ms(lambda: A.auction_square_plain(
                        cost, eps, budget), 1),
                    library_ms=None)
        one = {"ospa_auction": case}
        B = cost.shape[0]
        # the cost read once, the owners and rounds written; AUCTION_OPS
        # per column scanned by each bid the rows made
        bound(one, "ospa_auction", 4 * (B * n * n + K + B * n + B * K),
              int(bids.sum()) * n * AUCTION_OPS)
        it = kern[1].float()
        rounds = it.sum(1)
        ctas = lib.phd_auction_square_ctas_per_sm(n, ctypes.byref(regs))
        log(f"square auction [{B}, {n}, {n}] (path "
            f"{lib.phd_auction_square_path(n)}: 3 the cost in shared memory "
            f"and registers, 2 in shared memory, 1 in device memory; "
            f"{regs.value} registers, {ctas} CTAs per SM): bit-identical to "
            f"plain; rounds per phase mean "
            + ", ".join(f"{v:.1f}" for v in it.mean(0).tolist())
            + f", max {int(kern[1].max())} (budget {budget}); bids "
            f"{int(bids.sum()) / B:.0f} a problem; {case['ms']:.4f} ms "
            f"(plain {case['plain_ms']:.3f} ms, bound {case['bound_ms']:.3e}"
            f" ms by {case['bound_by']}); "
            f"{case['ms'] * 1e3 / float(rounds.mean()):.3f} us a round over "
            f"the mean {float(rounds.mean()):.1f} rounds a problem, "
            f"{case['ms'] * 1e3 / float(rounds.max()):.3f} over the most "
            f"({int(rounds.max())})")
        if n == 256 and lib.phd_auction_square_path(n) < 2:
            raise RuntimeError("square auction: the cost at n = 256 is not "
                               "on chip")
        if n == max(OSPA_SIZES):    # the largest size goes to the JSON
            stats["ospa_auction"].update(case)
    n = OSPA_BUDGET_N
    cost = torch.stack([
        O.padded_cost(*ospa_sets(n, s, dev)[4], OSPA_P, OSPA_C)[1]
        for s in range(OSPA_SEEDS)]).contiguous()
    kern = A.auction_square_cuda(cost, eps, OSPA_BUDGET)
    square_exact(kern, A.auction_square_plain(cost, eps, OSPA_BUDGET),
                 f"n = {n}, {OSPA_BUDGET} rounds a phase")
    if int(kern[1][:, -1].min()) != OSPA_BUDGET:
        raise RuntimeError("square auction: the budget case did not stop at "
                           "the budget")
    log(f"square auction [{OSPA_SEEDS}, {n}, {n}] at {OSPA_BUDGET} rounds a "
        "phase: bit-identical to plain (the clean-up pairs the rows left)")

    # the entry point, counts from 0: one launch per ospa_torch call
    zero_launch_counts()
    out = {n: [O.ospa_torch(*pr[4], p=OSPA_P, c=OSPA_C) for pr in pairs[n]]
           for n in OSPA_SIZES}
    torch.cuda.synchronize()
    launches = launch_counts()
    check_launches(launches, dict(
        ospa_auction=len(OSPA_SIZES) * OSPA_SEEDS, auction=0, select=0,
        merge=0), "ospa_torch")
    stats["ospa_auction"]["launches"] = launches["ospa_auction"]
    for n in OSPA_SIZES:
        gaps, card_gaps = [], []
        for pr, got in zip(pairs[n], out[n]):
            x, y, m_x, m_y, _ = pr
            ne, _, nc = ospa_np(x[:m_x], y[:m_y], p=OSPA_P, c=OSPA_C)
            gaps.append(abs(float(got[0]) - ne))
            card_gaps.append(abs(float(got[2]) - nc))
        args = pairs[n][0][4]
        ms = cuda_ms(lambda: O.ospa_torch(*args, p=OSPA_P, c=OSPA_C), 10)
        log(f"ospa_torch n = {n}: |ospa - ospa_np| max {max(gaps):.2e} "
            f"(bar {OSPA_TOL}), card max {max(card_gaps):.2e}; {ms:.4f} ms "
            f"a call (CUDA events, seed 0)")
        if max(gaps) >= OSPA_TOL or max(card_gaps) >= OSPA_CARD_TOL:
            raise RuntimeError(f"ospa_torch n = {n}: off ospa_np")
    log(f"phase ospa: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------- phase 2: past the old limits --

def phase_wide(dev, stats):
    """One case past each kernel's shared-memory or register limit (the
    rows and pools a CTA cannot hold), at small P: the kernels'
    device-memory paths against plain, timed."""
    from phdslam_tpu_torch.kernels import _build
    S, S4, G, G4, G3, _ = _mods()
    t0 = time.perf_counter()
    lib, _ = _build.library()
    P, F, M = WIDE["P"], WIDE["F"], WIDE["M"]
    occupancy(lib.phd_select_ctas_per_sm, F, f"select at F = {F} (wide)")
    occupancy(lib.phd_select4_ctas_per_sm, F, f"select4 at F = {F} (wide)")
    cfg, pre, gm, z = random_select_inputs(P, F, M, 60, dev)
    chans, kw, nv = _select_args(S, cfg, pre, gm, z, dict(
        raw=False, with_compat=True, with_lpw=True, nv=None))
    kern = S.select_cuda(chans, z, nv, **kw)
    n_bad, err = select_outputs_agree(kern, S.select_plain(chans, z, nv,
                                                           **kw))
    _limit(n_bad, P, f"select {P}x{F}x{M}")
    _err(stats, "select", err)
    _, err_b = check_by_index(S, pre, gm, z, chans, nv, kw, kern,
                              f"{P}x{F}x{M} (wide)")
    _err(stats, "select_by_index", err_b)
    kwb = dict(kw, by_index=True)
    pre4, gm4, z4 = random_select4_inputs(P, F, M, 61, dev)
    loop, gain, mean, cov = S4.select4_channels(pre4, gm4)
    loop = [c.contiguous() for c in loop]
    k4 = S4.select4_cuda(loop, gain, mean, cov, z4, k1=K1)
    n4, err4 = select4_outputs_agree(k4, S4.select4_plain(
        loop, gain, mean, cov, z4, k1=K1))
    i4 = S4.select4_cuda(loop, None, None, None, z4, k1=K1, by_index=True)
    n4i, err4i = compare_rows(i4, S4.select4_plain(
        loop, None, None, None, z4, k1=K1, by_index=True))
    _limit(n4 + n4i, P, f"select4 {P}x{F}x{M}")
    _err(stats, "select4", err4)
    _err(stats, "select4_by_index", err4i)
    runs = dict(
        select=lambda: S.select_cuda(chans, z, nv, **kw),
        select_by_index=lambda: S.select_cuda(chans[:S_LOOP], z, nv, **kwb),
        select4=lambda: S4.select4_cuda(loop, gain, mean, cov, z4, k1=K1),
        select4_by_index=lambda: S4.select4_cuda(
            loop, None, None, None, z4, k1=K1, by_index=True))
    log(f"wide rows {P}x{F}x{M}: select {n_bad}/{P} differing (max_abs_err "
        f"{err:.3e}), select4 {n4}/{P} ({err4:.3e}), by index {n4i}/{P}; "
        + ", ".join(f"{k} {cuda_ms(fn, 5):.4f} ms" for k, fn in runs.items()))
    for i, (name, P, K, cap) in enumerate(WIDE_MERGES):
        if name == "merge":
            pool = random_pool(P, K, 70 + i, dev)
            args = (5.0, cap, 0)
            fns = (G.merge_cuda, G.merge_plain)
        elif name == "merge4":
            pool = random_pool4(P, K, 70 + i, dev)
            args = (1.0, cap)
            fns = (G4.merge4_cuda, G4.merge4_plain)
        else:
            pool = random_pool3(P, K, 70 + i, dev)
            args = (4.0, cap)
            fns = (G3.merge3_cuda, G3.merge3_plain)
        n_scratch = getattr(lib, f"phd_{name}_wide_floats")(P, K)
        if n_scratch == 0:
            raise RuntimeError(f"{name} [{P}, {K}]: expected the "
                               "device-memory pool path")
        kern = fns[0](*pool, *args)
        plain = fns[1](*pool, *args)
        bad, errs = differing_rows(kern, plain)
        n_bad = int(bad.sum())
        err = float(errs[~bad].max()) if n_bad < P else 0.0
        if n_bad:                   # rounding, if float64 sides with it
            by_kern, _ = float64_sides(kern, plain, bad, fns[1], pool, dict(
                zip(("min_separation", "max_out", "metric"), args)))
            log(f"{name} [{P}, {K}]: {n_bad}/{P} particles differ, the "
                f"plain version in float64 agrees with the kernel on "
                f"{by_kern}")
            if by_kern < n_bad:
                _limit(n_bad, P, f"{name} [{P}, {K}] -> {cap}")
        _err(stats, name, err)
        bit_identical(lambda: fns[0](*pool, *args), f"{name} [{P}, {K}]")
        log(f"{name} [{P}, {K}] -> {cap} (device-memory pools, "
            f"{n_scratch * 4 / 2**20:.1f} MiB): particles differing "
            f"{n_bad}/{P}, max_abs_err {err:.3e}, live slots "
            f"{int((kern[0] > 0).sum(1).max())} max; "
            f"{cuda_ms(lambda: fns[0](*pool, *args), 3):.4f} ms")
    log(f"phase wide shapes: ok ({time.perf_counter() - t0:.1f} s)")


# --------------------------------------------- the kernels on real inputs --

class _KernelTimer:
    """Record CUDA events around every launch of one kernel wrapper, and
    the arguments of the last launch."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.pairs = []
        self.last_args = self.last_out = None
        self.kept = None            # a list: keep every launch's (a, kw, out)

    def __enter__(self):
        import torch

        def timed(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.orig(*a, **kw)
            e.record()
            self.pairs.append((s, e))
            self.last_args = (a, kw)
            self.last_out = out
            if self.kept is not None:
                clone = lambda x: x.clone() if torch.is_tensor(x) else x
                self.kept.append((tuple(map(clone, a)), kw,
                                  tuple(map(clone, out))))
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def ms(self):
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def timers():
    """One _KernelTimer per kernel wrapper: select (both modes), select4
    (both modes), merge, merge4, merge3, esf, auction, the square
    auction, preupdate."""
    S, S4, G, G4, G3, E = _mods()
    return dict(select=_KernelTimer(S, "select_cuda"),
                select4=_KernelTimer(S4, "select4_cuda"),
                merge=_KernelTimer(G, "merge_cuda"),
                merge4=_KernelTimer(G4, "merge4_cuda"),
                merge3=_KernelTimer(G3, "merge3_cuda"),
                esf=_KernelTimer(E, "esf_all_cuda"),
                auction=_KernelTimer(_auction(), "auction_assign_cuda"),
                ospa_auction=_KernelTimer(_auction(), "auction_square_cuda"),
                preupdate=_KernelTimer(_preupdate(), "preupdate_cuda"))


def agree_on_last_args(tm, stats, what):
    """Run every kernel the timers saw, and its plain version, again on the
    arguments of its last launch; returns the names of the kernels held."""
    S, S4, G, G4, G3, E = _mods()
    plain_of = dict(select=S.select_plain, select4=S4.select4_plain,
                    merge=G.merge_plain, merge4=G4.merge4_plain,
                    merge3=G3.merge3_plain, esf=E.esf_all_plain,
                    auction=_auction().auction_assign_plain,
                    ospa_auction=_auction().auction_square_plain,
                    preupdate=_preupdate().preupdate_plain)
    parts, held = [], set()
    for name, t in tm.items():
        if t.last_args is None:
            continue
        a, kw = t.last_args
        kern, plain = t.orig(*a, **kw), plain_of[name](*a, **kw)
        by = kw.get("by_index", False)
        if by:
            n_bad, err = compare_rows(kern, plain)
        elif name == "select":
            n_bad, err = select_outputs_agree(kern, plain)
        elif name == "select4":
            n_bad, err = select4_outputs_agree(kern, plain)
        elif name == "esf":
            n_bad, err = esf_agree(kern, plain)
            esf_exact(kern, plain, f"{what} inputs")
        elif name == "auction":
            n_bad, err = auction_exact(kern, plain,
                                       a[0].shape[1] + a[0].shape[2],
                                       f"{what} inputs")
        elif name == "ospa_auction":
            square_exact(kern, plain, f"{what} inputs")
            n_bad, err = 0, 0.0
        elif name == "preupdate":
            bad = _cases().preupdate_channels_differing(kern, plain)
            if bad:
                raise RuntimeError(f"preupdate ({what} inputs): channels "
                                   f"differ from the plain chain (largest "
                                   f"ulp gaps): {bad}")
            n_bad, err = 0, 0.0
        else:
            n_bad, err = compare_rows(kern, plain)
        P = kern[0].shape[0]
        key = name + ("_by_index" if by else "")
        _limit(n_bad, P, f"{key} ({what} inputs)")
        _new_stats(stats, key)
        _err(stats, key, err)
        held.add(key)
        parts.append(f"{key} {'x'.join(map(str, kern[1].shape))} "
                     f"{n_bad}/{P} (max_abs_err {err:.3e})")
    log(f"{what} inputs, kernels against plain, particles differing: "
        + "; ".join(parts))
    return held


def float64_sides(out, plain, bad, plain_fn, a, kw):
    """The particles marked bad run again through the plain version in
    float64: (how many the kernel's outputs agree with, how many the
    float32 plain version's agree with), each within rtol/atol."""
    import torch
    i = bad.nonzero()[:, 0]
    ref = [r.float() for r in plain_fn(*(
        x[i].double() if torch.is_tensor(x) else x for x in a), **kw)]
    n = len(i)
    return (n - compare_rows([o[i] for o in out], ref)[0],
            n - compare_rows([q[i] for q in plain], ref)[0])


def agree_on_every_launch(t, plain_fn, stats, what):
    """Every launch the timer kept against the plain version on the same
    inputs: at most MAX_DIFFER of the particles over all launches differ.
    The plain version runs once on the inputs of all launches of one shape
    and one set of scalars, stacked on the particle axis (each particle's
    result is its own). A particle that differs is run again through the
    plain version in float64, to see which of the two float32 results it
    sides with."""
    import torch
    key = lambda a, kw: (tuple(tuple(x.shape[1:]) if torch.is_tensor(x)
                               else x for x in a), tuple(sorted(kw.items())))
    groups = {}
    for a, kw, out in t.kept:
        groups.setdefault(key(a, kw), []).append((a, kw, out))
    plains = []
    for runs in groups.values():
        a0, kw0, _ = runs[0]
        stacked = plain_fn(*(torch.cat([r[0][i] for r in runs])
                             if torch.is_tensor(x) else x
                             for i, x in enumerate(a0)), **kw0)
        lo = 0
        for a, kw, out in runs:
            n = out[0].shape[0]
            plains.append((a, kw, out, [p[lo:lo + n] for p in stacked]))
            lo += n
    n_bad = n_rows = worst = by_kern = by_plain = 0
    err = 0.0
    for a, kw, out, plain in plains:
        bad, errs = differing_rows(out, plain)
        b = int(bad.sum())
        n_bad, n_rows = n_bad + b, n_rows + out[0].shape[0]
        worst = max(worst, b)
        err = max(err, float(torch.where(bad, 0.0, errs).max()))
        if b:
            k, q = float64_sides(out, plain, bad, plain_fn, a, kw)
            by_kern, by_plain = by_kern + k, by_plain + q
    log(f"{what}: {t.name} against plain on every one of its {len(t.kept)}"
        f" launches: particles differing {n_bad}/{n_rows} (at most {worst} "
        f"in one launch), max_abs_err {err:.3e}; of those, the plain version"
        f" in float64 agrees with the kernel on {by_kern} and with the "
        f"float32 plain version on {by_plain}")
    _limit(n_bad, n_rows, f"{t.name} ({what}, every launch)")
    _err(stats, t.name.removesuffix("_cuda"), err)


def run_cli(args, tm):
    """runner.main(args) with every launch count set to 0 just before and
    every timer on; returns (launch counts, run seconds, runner.main's
    result)."""
    from contextlib import ExitStack

    from phdslam_tpu_torch import runner
    zero_launch_counts()
    t_run = time.perf_counter()
    with ExitStack() as stack:
        for t in tm.values():
            stack.enter_context(t)
        res = runner.main(args)
    return launch_counts(), time.perf_counter() - t_run, res


def runner_args(d, out, dev, seed=0, extra=(), mode="loop"):
    """The synth runner's arguments for d/run.cfg on the run files in d,
    in mode (loop unless extra names another)."""
    return [str(Path(d, "run.cfg")), "synth", "--measurements",
            str(Path(d, "measurements.txt")), "--controls",
            str(Path(d, "controls.txt")), "--data-dir", str(d),
            "--out-dir", str(out), "--mode", mode, "--device", dev.type,
            "--seed", str(seed), *extra]


def run_runner(d, cfg_text, steps_cfg, dev, tm, seed=0, extra=(), out=None,
               mode="loop"):
    """The synth runner in mode (loop or scan) on the run files in d, with
    the extra arguments, into out (default: a new out<N> in d); returns
    (launch counts, run seconds, out dir)."""
    Path(d, "run.cfg").write_text(cfg_text + steps_cfg)
    out = out or Path(d, f"out{len(list(Path(d).glob('out*')))}")
    launches, run_s, _ = run_cli(runner_args(d, out, dev, seed, extra, mode),
                                 tm)
    return launches, run_s, out


def metrics_rows(out, skip=("ms",)):
    """The metrics.jsonl lines of a run, without the keys in skip."""
    return [{k: v for k, v in json.loads(line).items() if k not in skip}
            for line in (Path(out) / "metrics.jsonl").read_text()
            .splitlines()]


def same_logs(ref, got, steps, what):
    """Raise unless the run in got wrote ref's state_estimate log of every
    step in steps byte for byte, and ref's metrics.jsonl lines of those
    steps apart from their ms (loopTime.log: a line a step)."""
    differ = [t for t in steps
              if Path(got, f"state_estimate{t:05d}.log").read_bytes()
              != Path(ref, f"state_estimate{t:05d}.log").read_bytes()]
    n_logs = len(list(Path(got).glob("state_estimate*.log")))
    rows = {r["t"]: r for r in metrics_rows(ref)}
    same_rows = metrics_rows(got) == [rows[t] for t in steps]
    n_times = len(Path(got, "loopTime.log").read_text().split())
    if differ or n_logs != len(steps) or n_times != len(steps) \
            or not same_rows:
        raise RuntimeError(
            f"{what}: the logs of steps {differ[:5]}"
            f"{' ...' if len(differ) > 5 else ''} ({len(differ)} of "
            f"{len(steps)}) differ, {n_logs} logs, {n_times} times, "
            f"metrics {'equal' if same_rows else 'differ'}")


def scan_as_loop(run, loop_out, n_steps, expect, what):
    """run() -> (launch counts, run seconds, out dir): the runner in scan
    mode on the run loop_out's loop run read, launch counts from 0. Every
    state_estimate log byte for byte the loop run's and every metrics line
    the same apart from its ms (``same_logs``); each kernel launched as
    expect says. Returns the scan's ms a step."""
    launches, run_s, out = run()
    check_launches(launches, expect, f"{what}, scan mode")
    same_logs(loop_out, out, range(n_steps), f"{what}, scan mode")
    ms = float(np.loadtxt(Path(out, "loopTime.log")).mean())
    log(f"{what}, scan mode: its {n_steps} state_estimate logs byte for "
        f"byte the loop run's, metrics.jsonl equal apart from ms; "
        f"launches " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                 if v)
        + f"; {ms:.3f} ms/step, run {run_s:.1f} s")
    return ms


def check_launches(launches, expect, what):
    for k, v in expect.items():
        if launches[k] != v:
            raise RuntimeError(f"{what}: {k} launched {launches[k]} times, "
                               f"expected {v}")


# ------------------------------------------------- phase 3: main path --

def static_run_files(d):
    """The run of phases 3, 6 and 6b in d: simdata.make_scenario(rng(0)),
    330 steps, measurements from generate_run(rng(1)), every step with
    measurements (so every step updates). Returns (scenario, steps, the cfg
    lines of its start pose, appended to cfg/ackerman_synth.cfg)."""
    from phdslam_tpu_torch import simdata
    sc = simdata.make_scenario(np.random.default_rng(0), n_steps=RUN_STEPS)
    controls, meas = simdata.generate_run(np.random.default_rng(1), sc,
                                          control_noise=(0.2, 0.01))
    if not all(len(z) for z in meas):
        raise RuntimeError("scenario has a step without measurements")
    simdata.write_run_files(d, controls, meas)
    x0, y0, yaw0 = sc.traj[0]
    return sc, len(meas), (f"\ninitial_x = {x0}\ninitial_y = {y0}\n"
                           f"initial_yaw = {yaw0}\n")


def pose_errors(out, traj, n_steps, dims):
    """The logs of a run in out, and the distance of each step's pose
    (its first dims entries) from traj[t, :dims]."""
    from phdslam_tpu_torch.io.logs import read_state_estimate_log
    logs = [read_state_estimate_log(str(out / f"state_estimate{t:05d}.log"))
            for t in range(n_steps)]
    return logs, np.array([np.linalg.norm(lg["pose"][:dims] - traj[t, :dims])
                           for t, lg in enumerate(logs)])


def phase_main_path(dev, stats):
    t0 = time.perf_counter()
    tm = timers()
    with tempfile.TemporaryDirectory() as d:
        sc, n_steps, start = static_run_files(d)
        cfg_text = (ROOT / "cfg/ackerman_synth.cfg").read_text()
        launches, run_s, out = run_runner(d, cfg_text, start, dev, tm)
        n_logs = len(list(out.glob("state_estimate*.log")))
        loop_ms = np.loadtxt(out / "loopTime.log")
        _, errs = pose_errors(out, sc.traj, n_steps, 2)
        stats.setdefault("scan_ms_per_step", {})["static"] = scan_as_loop(
            lambda: run_runner(d, cfg_text, start, dev, {}, mode="scan"),
            out, n_steps, dict(select=n_steps, merge=n_steps, esf=0,
                               auction=0, preupdate=n_steps),
            "static main path")
    # every step of this run has measurements, so every step updates
    n_update = n_steps
    log(f"main path: {n_steps} steps, {n_logs} state_estimate logs, "
        f"launches {launches} (update steps {n_update}), pose error mean "
        f"{errs.mean():.3f} m max {errs.max():.3f} m, {loop_ms.mean():.3f} "
        f"ms/step (median {np.median(loop_ms):.3f}, incl. per-step log "
        f"host copies), run {run_s:.1f} s")
    if n_logs != n_steps or len(loop_ms) != n_steps:
        raise RuntimeError("log contract incomplete")
    check_launches(launches, dict(select=n_update, merge=n_update,
                                  select_by_index=0, select4=0,
                                  select4_by_index=0, merge4=0, merge3=0,
                                  esf=0, auction=0, preupdate=n_update),
                   "static main path")
    if not np.isfinite(errs).all() or errs.mean() >= POSE_BAR_M:
        raise RuntimeError(f"mean pose error {errs.mean():.3f} m is not "
                           f"below {POSE_BAR_M} m")
    agree_on_last_args(tm, stats, "static main path")
    a, kw = tm["select"].last_args
    w_sel = tm["select"].orig(*a, **kw)[1]
    early, rounds, live = select_rows(w_sel, a[0][2], int(a[2]))
    log(f"static main path, select's last launch "
        f"{'x'.join(map(str, w_sel.shape))} (n_valid {int(a[2])}): rows "
        f"exiting early {early:.4f}, rounds per row {rounds:.3f} of "
        f"{w_sel.shape[-1]}, live slots per particle {live:.1f}")
    log(f"main path kernels: select {tm['select'].ms() / n_steps:.4f} "
        f"ms/step, merge {tm['merge'].ms() / n_steps:.4f} ms/step, "
        f"preupdate {tm['preupdate'].ms() / n_steps:.4f} ms/step (CUDA "
        f"events)")
    for k in ("select", "merge", "preupdate"):
        stats[k]["launches"] = launches[k]
    stats["shipped_ms_per_step"] = float(loop_ms.mean())
    stats["shipped_pose_err"] = float(errs.mean())
    log(f"phase main path: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------ phase 3b: resume --

def resume_pair(run, steps, what):
    """run(extra, out) -> (launch counts, seconds, out dir): the straight
    run with --checkpoint-every RESUME_EVERY, then a fresh out-dir holding
    only the checkpoint after step RESUME_FROM run with --resume (launch
    counts from 0). Returns (the straight and resumed out dirs, the
    resumed run's launches, the checkpoints kept, the seconds of each)."""
    _, run_s, straight = run(("--checkpoint-every", str(RESUME_EVERY)),
                             None)
    ckpts = sorted(p.name for p in (straight / "checkpoints").iterdir())
    expect = [f"ckpt_{t:06d}.npz"
              for t in range(RESUME_EVERY, steps, RESUME_EVERY)]
    if ckpts != expect[-3:]:
        raise RuntimeError(f"{what} resume: checkpoints {ckpts}, expected "
                           f"{expect[-3:]}")
    out = Path(straight.parent, straight.name + "_resumed")
    (out / "checkpoints").mkdir(parents=True)
    name = f"ckpt_{RESUME_FROM:06d}.npz"
    (out / "checkpoints" / name).write_bytes(
        (straight / "checkpoints" / name).read_bytes())
    launches, res_s, _ = run(("--resume",), out)
    return straight, out, launches, ckpts, (run_s, res_s)


def resumed_lines_valid(out, steps, cphd, what):
    """Every resumed step's log: finite log-weights summing to 1 within
    1e-3 and, under CPHD, a normalised cardinality log-pmf."""
    from phdslam_tpu_torch.io.logs import read_state_estimate_log
    for t in steps:
        lg = read_state_estimate_log(str(out / f"state_estimate{t:05d}.log"))
        w = lg["weights"]
        ok = np.isfinite(w).all() and abs(np.exp(w.astype(np.float64)).sum()
                                          - 1.0) < 1e-3
        if cphd:
            with np.errstate(over="ignore"):
                pmf = np.exp(lg["cardinality"].astype(np.float64))
            ok = ok and np.isfinite(pmf).all() \
                and abs(np.log(pmf.sum())) < 1e-3
        if not ok:
            raise RuntimeError(f"{what} resume: step {t}'s weights or "
                               "cardinality line invalid")


# (name, cfg, cfg lines, run files, resumed logs byte for byte, kernels
# launched once a resumed step): the straight run byte for byte unless the
# filter reads the previous step's measurements (CPHD births, the mixed
# model's birth_velocity_init), which a checkpoint does not hold (as in
# JAX): then the first resumed step differs
RESUME_CASES = (
    ("static", "cfg/ackerman_synth.cfg", "", "static", True,
     ("select", "merge", "preupdate")),
    ("FastSLAM", "cfg/fastslam_synth.cfg",
     "std_range = 0.25\nclutter_rate = 2.0\n", "static", True,
     ("auction", "preupdate")),
    ("mixed", "cfg/mixed_synth.cfg", "", "mixed", True,
     ("select", "select4", "merge", "merge4", "preupdate")),
    ("mixed birth_velocity_init", "cfg/mixed_synth.cfg",
     "birth_velocity_init = 1\n", "mixed", False,
     ("select", "select4", "merge", "merge4", "preupdate")),
    ("CPHD", "cfg/ackerman_synth.cfg", "filter_type = 1\n", "static",
     False, ("esf", "select", "merge", "preupdate")),
)


def phase_resume(dev, stats):
    """Each filter's runner over RESUME_STEPS steps of phase 3's run
    (mixed: of phase 4's) with --checkpoint-every RESUME_EVERY, then,
    counts from 0, a fresh out-dir holding only the checkpoint after step
    RESUME_FROM run with --resume: every later step's log byte-identical
    to the straight run's and its metrics line the same apart from ms
    (static, FastSLAM at clutter 2, mixed); the first resumed step's log
    differing and every later one with finite weights and (CPHD) a
    normalised cardinality line (CPHD, mixed with birth_velocity_init);
    the filter's kernels launched once per resumed update step. Then the
    disparity runner over its 100 steps, resumed byte for byte the
    same way."""
    t0 = time.perf_counter()
    steps = range(RESUME_FROM + 1, RESUME_STEPS)
    kinds = ("select", "select4", "merge", "merge4", "merge3", "esf",
             "auction", "preupdate")
    with tempfile.TemporaryDirectory() as d:
        files = dict(static=static_run_files(Path(d, "static"))[2],
                     mixed=mixed_run_files(Path(d, "mixed"))[3])
        for name, cfg_file, lines, data, exact, kernels in RESUME_CASES:
            cfg_text = (ROOT / cfg_file).read_text() + lines
            steps_cfg = files[data] + f"n_steps = {RESUME_STEPS}\n"
            run = lambda extra, out: run_runner(
                Path(d, data), cfg_text, steps_cfg, dev, {}, extra=extra,
                out=out)
            straight, out, launches, ckpts, secs = resume_pair(
                run, RESUME_STEPS, name)
            first = f"state_estimate{steps[0]:05d}.log"
            if exact:
                same_logs(straight, out, steps, f"{name} resume")
            elif (out / first).read_bytes() == (straight / first) \
                    .read_bytes():
                raise RuntimeError(f"{name} resume: the first resumed "
                                   "step's log equals the straight run's")
            else:
                resumed_lines_valid(out, steps, "filter_type = 1" in lines,
                                    name)
                n_logs = len(list(out.glob("state_estimate*.log")))
                if n_logs != len(steps):
                    raise RuntimeError(f"{name} resume: {n_logs} logs")
            check_launches(launches, {k: len(steps) if k in kernels else 0
                                      for k in kinds}, f"resumed {name} run")
            log(f"resume, {name}: straight run {RESUME_STEPS} steps "
                f"({secs[0]:.1f} s), checkpoints {ckpts}; resumed from "
                f"step {RESUME_FROM} ({secs[1]:.1f} s): steps {steps[0]}-"
                f"{steps[-1]} "
                + ("byte for byte the straight run's (logs; metrics apart "
                   "from ms)" if exact else
                   f"written, step {steps[0]} differing from the straight "
                   "run's (no previous measurements after a resume, as in "
                   "JAX), every resumed step's weights finite"
                   + (" and cardinality normalised"
                      if "filter_type" in lines else ""))
                + ", launches " + ", ".join(f"{k} {v}" for k, v in
                                            launches.items() if v))

        n_disp = len(np.loadtxt(DISP_DATA / "traj.txt", comments="%"))
        disp = Path(d, "disparity")
        run = lambda extra, out: run_disparity(
            out or disp, dev, {}, extra=extra) + (out or disp,)
        straight, out, launches, ckpts, secs = resume_pair(
            run, n_disp, "disparity")
        d_steps = range(RESUME_FROM + 1, n_disp)
        same_logs(straight, out, d_steps, "disparity resume")
        n_update = sum(r["n_measure"] > 0 for r in metrics_rows(out))
        check_launches(launches, {k: n_update if k == "merge3" else 0
                                  for k in kinds}, "resumed disparity run")
        log(f"resume, disparity: straight run {n_disp} steps "
            f"({secs[0]:.1f} s), checkpoints {ckpts}; resumed from step "
            f"{RESUME_FROM} ({secs[1]:.1f} s): steps {d_steps[0]}-"
            f"{d_steps[-1]} byte for byte the straight run's (logs; "
            f"metrics apart from ms), launches merge3 {launches['merge3']}")
    log(f"phase resume: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------- phase 4: mixed main path --

def mover_share(logs, truth, traj, cfg):
    """Share of the settled mover steps (a mover in the field of view of
    the true pose for 4+ steps in a row) on which the logged dynamic map
    holds a component of weight >= 0.05 within 2 m of it."""
    streak = np.zeros(truth.shape[1], int)
    hits = []
    for t, lg in enumerate(logs):
        dyn = lg["dynamic"]
        comp = dyn[dyn[:, 0] >= 0.05][:, 1:3]
        for k in range(truth.shape[1]):
            d = truth[t, k] - traj[t, :2]
            r = np.linalg.norm(d)
            b = np.arctan2(d[1], d[0]) - traj[t, 2]
            b = np.arctan2(np.sin(b), np.cos(b))
            if not (cfg.minRange <= r <= cfg.maxRange
                    and abs(b) <= cfg.maxBearing):
                streak[k] = 0
                continue
            streak[k] += 1
            if streak[k] >= 4:
                hits.append(bool(len(comp)) and bool(
                    np.linalg.norm(comp - truth[t, k], axis=1).min() < 2.0))
    return float(np.mean(hits)) if hits else float("nan"), len(hits)


def mixed_run_files(d):
    """The mover run of phases 4 and 3b in d: scripts/mixed_evidence.py's
    scenario (40 landmarks, three movers, seed 500), every step with
    measurements. Returns (scenario, the movers' truth, steps, the cfg
    lines of its start pose)."""
    from phdslam_tpu_torch import simdata
    from phdslam_tpu_torch.evidence.mixed import MOVER0, MOVER_V
    sc = simdata.make_scenario(np.random.default_rng(11),
                               n_landmarks=MIXED_LANDMARKS,
                               n_steps=MIXED_STEPS)
    controls, meas, truth = simdata.generate_mixed_run(
        np.random.default_rng(500), sc, MOVER0, MOVER_V,
        control_noise=(0.2, 0.01))
    if not all(len(z) for z in meas):
        raise RuntimeError("mixed scenario has a step without measurements")
    simdata.write_run_files(str(d), controls, meas)
    x0, y0, yaw0 = sc.traj[0]
    return sc, truth, len(meas), (f"\ninitial_x = {x0}\ninitial_y = {y0}"
                                  f"\ninitial_yaw = {yaw0}\n")


def phase_mixed_main_path(dev, stats):
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.io.logs import read_state_estimate_log

    t0 = time.perf_counter()
    base = (ROOT / "cfg/mixed_synth.cfg").read_text()
    cfg = load_config(str(ROOT / "cfg/mixed_synth.cfg"))
    tm = timers()
    with tempfile.TemporaryDirectory() as d:
        sc, truth, n_steps, start = mixed_run_files(d)
        launches, run_s, out = run_runner(d, base, start, dev, tm)
        logs = [read_state_estimate_log(str(out / f"state_estimate{t:05d}"
                                            ".log")) for t in range(n_steps)]
        loop_ms = np.loadtxt(out / "loopTime.log")
        errs = np.array([np.linalg.norm(lg["pose"][:2] - sc.traj[t, :2])
                         for t, lg in enumerate(logs)])
        share, n_settled = mover_share(logs, truth, sc.traj, cfg)
        n_dyn = np.array([len(lg["dynamic"]) for lg in logs])
        log(f"mixed main path: {n_steps} steps, launches {launches}, pose "
            f"error mean {errs.mean():.3f} m max {errs.max():.3f} m, "
            f"settled mover steps {n_settled} confirmed {share:.3f}, "
            f"dynamic components logged mean {n_dyn.mean():.1f}, "
            f"{loop_ms.mean():.3f} ms/step (median "
            f"{np.median(loop_ms):.3f}), run {run_s:.1f} s")
        if len(loop_ms) != n_steps or not all(
                lg["dynamic"].shape[1] == 21 for lg in logs) \
                or n_dyn.max() == 0:
            raise RuntimeError("mixed log contract incomplete")
        check_launches(launches, dict(select=n_steps, select4=n_steps,
                                      merge=n_steps, merge4=n_steps,
                                      select_by_index=0,
                                      select4_by_index=0, merge3=0, esf=0,
                                      auction=0, preupdate=n_steps),
                       "mixed main path")
        if not np.isfinite(errs).all() or errs.mean() >= MIXED_POSE_BAR_M:
            raise RuntimeError(f"mixed: mean pose error {errs.mean():.3f} "
                               f"m is not below {MIXED_POSE_BAR_M} m")
        if not share >= MOVER_SHARE:
            raise RuntimeError(f"mixed: movers confirmed on {share:.3f} of "
                               f"{n_settled} settled steps, below "
                               f"{MOVER_SHARE}")
        agree_on_last_args(tm, stats, "mixed main path")
        log(f"mixed main path kernels (CUDA events, ms/step): " + ", ".join(
            f"{k} {t.ms() / n_steps:.4f}" for k, t in tm.items() if t.pairs))
        for k in ("select4", "merge4"):
            stats[k]["launches"] = launches[k]
        stats.setdefault("scan_ms_per_step", {})["mixed"] = scan_as_loop(
            lambda: run_runner(d, base, start, dev, {}, mode="scan"), out,
            n_steps, dict(select=n_steps, select4=n_steps, merge=n_steps,
                          merge4=n_steps, select_by_index=0,
                          select4_by_index=0, preupdate=n_steps),
            "mixed main path")

        # the by-index modes, on the first steps of the same run
        tm = timers()
        launches, run_s, out = run_runner(
            d, base, start + f"n_steps = {BY_INDEX_STEPS}\n"
            "select_by_index = 1\n", dev, tm)
        check_launches(launches, dict(
            select_by_index=BY_INDEX_STEPS, select4_by_index=BY_INDEX_STEPS,
            merge=BY_INDEX_STEPS, merge4=BY_INDEX_STEPS, select=0,
            select4=0, preupdate=BY_INDEX_STEPS), "select_by_index pass")
        n_logs = len(list(out.glob("state_estimate*.log")))
        if n_logs != BY_INDEX_STEPS:
            raise RuntimeError("select_by_index pass: log contract")
        log(f"select_by_index pass: {BY_INDEX_STEPS} steps, launches "
            f"{launches}, run {run_s:.1f} s")
        agree_on_last_args(tm, stats, "select_by_index pass")
        for k in ("select_by_index", "select4_by_index"):
            stats[k]["launches"] = launches[k]
    stats["mixed_ms_per_step"] = float(loop_ms.mean())
    log(f"phase mixed main path: ok ({time.perf_counter() - t0:.1f} s)")


# --------------------------------------- phase 5: disparity main path --

DISP_DATA = ROOT / "data/disparity_synth"


def run_disparity(out, dev, tm, seed=0, mode="loop", extra=()):
    """The disparity runner in mode (loop or scan) on the shipped cfg and
    data, with the extra arguments; returns (launch counts, run
    seconds)."""
    return run_cli([str(ROOT / "cfg/disparity_synth.cfg"), "disparity",
                    "--data-dir", str(DISP_DATA), "--out-dir", str(out),
                    "--mode", mode, "--device", dev.type, "--seed",
                    str(seed), *extra], tm)[:2]


def phase_disparity_main_path(dev, stats):
    t0 = time.perf_counter()
    traj = np.loadtxt(DISP_DATA / "traj.txt", comments="%")
    tm = timers()
    with tempfile.TemporaryDirectory() as d:
        out = Path(d, "out")
        launches, run_s = run_disparity(out, dev, tm)
        loop_ms = np.loadtxt(out / "loopTime.log")
        n_steps = len(loop_ms)
        metrics = [json.loads(x) for x in
                   (out / "metrics.jsonl").read_text().splitlines()]
        logs, errs = pose_errors(out, traj, n_steps, 3)
        n_update = sum(m["n_measure"] > 0 for m in metrics)
        scan_out = Path(d, "scan")
        stats.setdefault("scan_ms_per_step", {})["disparity"] = scan_as_loop(
            lambda: run_disparity(scan_out, dev, {}, mode="scan")
            + (scan_out,), out, n_steps, dict(merge3=n_update, merge=0,
                                              preupdate=0),
            "disparity main path")
    n_map = np.array([len(lg["static"]) for lg in logs])
    log(f"disparity main path: {n_steps} steps, launches {launches} (steps "
        f"with measurements {n_update}), camera position error mean "
        f"{errs.mean():.3f} m max {errs.max():.3f} m, MAP features logged "
        f"mean {n_map.mean():.1f}, {loop_ms.mean():.3f} ms/step (median "
        f"{np.median(loop_ms):.3f}, incl. per-step log host copies), run "
        f"{run_s:.1f} s")
    if n_steps != len(traj) or not all(
            lg["pose"].shape == (12,) and lg["static"].shape[1] == 13
            for lg in logs if len(lg["static"])) or n_map.max() == 0:
        raise RuntimeError("disparity log contract incomplete")
    check_launches(launches, dict(merge3=n_update, select=0, merge=0,
                                  select_by_index=0, select4=0,
                                  select4_by_index=0, merge4=0, esf=0,
                                  auction=0, preupdate=0),
                   "disparity main path")
    if not np.isfinite(errs).all() or errs.mean() >= DISP_POSE_BAR_M:
        raise RuntimeError(f"disparity: mean camera error {errs.mean():.3f}"
                           f" m is not below {DISP_POSE_BAR_M} m")
    agree_on_last_args(tm, stats, "disparity main path")
    log(f"disparity main path kernels: merge3 "
        f"{tm['merge3'].ms() / n_steps:.4f} ms/step (CUDA events)")
    stats["merge3"]["launches"] = launches["merge3"]
    stats["disparity_ms_per_step"] = float(loop_ms.mean())
    log(f"phase disparity main path: ok ({time.perf_counter() - t0:.1f} s)")


# -------------------------------------------- phase 6: CPHD main path --

def phase_cphd_main_path(dev, stats):
    t0 = time.perf_counter()
    tm = timers()
    tm["merge"].kept = []
    with tempfile.TemporaryDirectory() as d:
        sc, n_steps, start = static_run_files(d)
        cfg_text = (ROOT / "cfg/ackerman_synth.cfg").read_text()
        launches, run_s, out = run_runner(
            d, cfg_text, start + "filter_type = 1\n", dev, tm)
        loop_ms = np.loadtxt(out / "loopTime.log")
        logs, errs = pose_errors(out, sc.traj, n_steps, 2)
        # step 0 of the scan gets an empty previous set, the loop none:
        # no births either way
        stats.setdefault("scan_ms_per_step", {})["CPHD"] = scan_as_loop(
            lambda: run_runner(d, cfg_text, start + "filter_type = 1\n",
                               dev, {}, mode="scan"), out, n_steps,
            dict(esf=n_steps, select=n_steps, merge=n_steps,
                 preupdate=n_steps), "CPHD main path")
    cn = np.stack([lg["cardinality"] for lg in logs])       # [T, N+1]
    with np.errstate(over="ignore"):
        pmf = np.exp(cn.astype(np.float64))
    lse = np.log(pmf.sum(1))
    e_n = (pmf * np.arange(cn.shape[1])).sum(1)
    log(f"CPHD main path: {n_steps} steps, launches {launches}, pose error "
        f"mean {errs.mean():.3f} m max {errs.max():.3f} m, cardinality "
        f"lines {cn.shape}, |logsumexp| max {np.abs(lse).max():.2e}, E[n] "
        f"of the MAP particle last {e_n[-1]:.2f} (mean {e_n.mean():.2f}), "
        f"{loop_ms.mean():.3f} ms/step (median {np.median(loop_ms):.3f}), "
        f"run {run_s:.1f} s")
    if len(loop_ms) != n_steps or cn.shape[1] != 256:
        raise RuntimeError("CPHD log contract incomplete")
    # a -inf entry is a zero probability (the Poisson prior of an empty
    # in-range submap): the check is on the pmf
    if not np.isfinite(pmf).all() or np.isnan(cn).any() \
            or np.abs(lse).max() > 1e-3:
        raise RuntimeError("CPHD: a cardinality line is not a normalised "
                           "log-pmf")
    # every step of this run has measurements, so every step updates
    check_launches(launches, dict(esf=n_steps, select=n_steps,
                                  merge=n_steps, select_by_index=0,
                                  select4=0, select4_by_index=0, merge4=0,
                                  merge3=0, auction=0, preupdate=n_steps),
                   "CPHD main path")
    if not tm["select"].last_args[1].get("raw"):
        raise RuntimeError("CPHD: the select kernel ran outside raw mode")
    if not np.isfinite(errs).all() or errs.mean() >= POSE_BAR_M:
        raise RuntimeError(f"CPHD: mean pose error {errs.mean():.3f} m is "
                           f"not below {POSE_BAR_M} m")
    agree_on_last_args(tm, stats, "CPHD main path")
    agree_on_every_launch(tm["merge"], _mods()[2].merge_plain, stats,
                          "CPHD main path")
    tm["merge"].kept = None
    log(f"CPHD main path kernels (CUDA events, ms/step): " + ", ".join(
        f"{k} {t.ms() / n_steps:.4f}" for k, t in tm.items() if t.pairs))
    stats["esf"]["launches"] = launches["esf"]
    stats["cphd_ms_per_step"] = float(loop_ms.mean())
    log(f"phase CPHD main path: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------- phase 6b: seed envelopes --

def phase_seed_envelopes(dev, stats):
    """The disparity and CPHD runs at each of ENVELOPE_SEEDS (the filter's
    seed: pose noise, resampling; the data stay): per-seed mean errors,
    their mean and standard deviation, every seed below its bar."""
    t0 = time.perf_counter()
    traj = np.loadtxt(DISP_DATA / "traj.txt", comments="%")
    cfg_text = (ROOT / "cfg/ackerman_synth.cfg").read_text()
    with tempfile.TemporaryDirectory() as d:
        disp = []
        for seed in ENVELOPE_SEEDS:
            out = Path(d, f"disp{seed}")
            run_disparity(out, dev, {}, seed)
            n = len(np.loadtxt(out / "loopTime.log"))
            disp.append(float(pose_errors(out, traj, n, 3)[1].mean()))
        sc, n_steps, start = static_run_files(d)
        cphd = []
        for seed in ENVELOPE_SEEDS:
            _, _, out = run_runner(d, cfg_text, start + "filter_type = 1\n",
                                   dev, {}, seed)
            cphd.append(float(pose_errors(out, sc.traj, n_steps,
                                          2)[1].mean()))
    for name, errs, bar in (("disparity camera", disp, DISP_POSE_BAR_M),
                            ("CPHD pose", cphd, POSE_BAR_M)):
        a = np.array(errs)
        log(f"seed envelope, {name} error (m), seeds "
            f"{list(ENVELOPE_SEEDS)}: " + ", ".join(f"{e:.4f}" for e in a)
            + f"; mean {a.mean():.4f}, std {a.std(ddof=1):.4f}")
        if not (np.isfinite(a).all() and (a < bar).all()):
            raise RuntimeError(f"seed envelope: a {name} error is not below "
                               f"{bar} m")
    log(f"phase seed envelopes: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------- phase 6e: Monte-Carlo envelope --

def mc_setup(n_steps=MC_STEPS):
    """scripts/round3_evidence.py::phase_variants' cfg and scenario, the
    scenario cut to its first n_steps steps."""
    import dataclasses

    from phdslam_tpu_torch.evidence.common import mc_base_cfg, mc_scenario
    base = mc_base_cfg()
    sc = mc_scenario(MC_STEPS)
    if n_steps < MC_STEPS:
        sc = dataclasses.replace(sc, traj=sc.traj[:n_steps + 1],
                                 controls_true=sc.controls_true[:n_steps])
    return base, sc


def update_steps(cfg, sc, runs):
    """(update steps of the runs one after another, steps at which some run
    updates): the launches of a per-update kernel on the sequential and on
    the vmapped path."""
    from phdslam_tpu_torch.eval import batch as B
    t_len = sc.traj.shape[0]
    has = np.stack([B._prepare_run(cfg, sc, r, 0, MC_CONTROL_NOISE,
                                   t_len)[3].any(1) for r in runs])
    return int(has.sum()), int(has.any(0).sum())


def phase_mc_envelope(dev, stats):
    """run_batch, the Monte-Carlo harness, on scripts/round3_evidence.py's
    variant setup for the PHD and the CPHD arm, sequential and then
    vmapped (the 20 runs in one chunk), counts from 0 before each run:
    select, merge and (CPHD) esf launched once per update step of each run
    (sequential) or once per step of the chunk (vmapped); each arm's
    late-half mean OSPA within the JAX record's ospa_late_std of its
    ospa_late_mean, its late-half mean pose error below MC_POSE_BAR_M;
    ms per run-step of both paths."""
    from phdslam_tpu_torch.eval import batch as B
    t0 = time.perf_counter()
    record = json.loads((ROOT / MC_RECORD).read_text())["variants"]
    base, sc = mc_setup()
    t_len = sc.traj.shape[0]
    half = t_len // 2
    n_update, n_update_vm = update_steps(base, sc, range(MC_RUNS))
    for arm, over in MC_ARMS:
        cfg = base.replace(**over)
        ms_seq = None
        for vmapped in (False, True):
            path = "vmapped" if vmapped else "sequential"
            zero_launch_counts()
            t_run = time.perf_counter()
            res = B.run_batch(cfg, sc, MC_RUNS,
                              control_noise=MC_CONTROL_NOISE,
                              collect_maps_every=MC_EVERY, vmapped=vmapped,
                              device=dev)
            launches = launch_counts()
            run_s = time.perf_counter() - t_run
            with warnings.catch_warnings():     # steps no run scored: NaN
                warnings.simplefilter("ignore", RuntimeWarning)
                agg = B.aggregate(res)
            ospa_late = float(np.nanmean(agg["ospa_mean"][half:]))
            ospa_late_std = float(np.nanmean(agg["ospa_std"][half:]))
            pose_late = float(agg["pose_err_mean"][half:].mean())
            ms = np.array([r.ms_per_step for r in res])
            ref = record[arm]
            n_up = n_update_vm if vmapped else n_update
            log(f"Monte-Carlo {arm} {path}: {MC_RUNS} runs x {t_len} steps, "
                f"launches {launches} (update steps {n_up}); late-half OSPA "
                f"{ospa_late:.4f} (std over runs {ospa_late_std:.4f}; JAX "
                f"record {ref['ospa_late_mean']:.4f} +- "
                f"{ref['ospa_late_std']:.4f}), late-half pose error "
                f"{pose_late:.4f} m (JAX {ref['pose_late_mean']:.4f}), card "
                f"error late {float(agg['card_err_mean'][half:].mean()):.3f} "
                f"(JAX {ref['card_err_late_mean']:.3f}); run_batch "
                f"{ms.mean():.3f} ms per run-step (runs {ms.min():.3f}-"
                f"{ms.max():.3f}), {run_s:.1f} s")
            check_launches(launches, dict(
                select=n_up, merge=n_up,
                esf=n_up if over.get("filterType") == 1 else 0,
                select_by_index=0, select4=0, select4_by_index=0, merge4=0,
                merge3=0, auction=0, ospa_auction=0, preupdate=n_up),
                f"Monte-Carlo {arm} {path}")
            if not abs(ospa_late - ref["ospa_late_mean"]) \
                    <= ref["ospa_late_std"]:
                raise RuntimeError(
                    f"Monte-Carlo {arm} {path}: late-half OSPA "
                    f"{ospa_late:.4f} is not within {ref['ospa_late_std']:.4f}"
                    f" of JAX's {ref['ospa_late_mean']:.4f}")
            if not pose_late < MC_POSE_BAR_M:
                raise RuntimeError(
                    f"Monte-Carlo {arm} {path}: late-half pose error "
                    f"{pose_late:.4f} m is not below {MC_POSE_BAR_M} m")
            if vmapped:
                stats[f"mc_{arm.lower()}_vmapped_ms_per_run_step"] = \
                    float(ms.mean())
                log(f"Monte-Carlo {arm}: vmapped {ms.mean():.3f} against "
                    f"sequential {ms_seq:.3f} ms per run-step "
                    f"({ms_seq / ms.mean():.2f}x)")
            else:
                ms_seq = float(ms.mean())
                stats[f"mc_{arm.lower()}_ms_per_step"] = ms_seq
    log(f"phase Monte-Carlo envelope: ok ({time.perf_counter() - t0:.1f} s)")


def phase_mc_one_step(dev, stats):
    """One batched step of MC_STEP_RUNS runs against each run stepped
    alone, on the card, from the same states (the runs stepped together for
    MC_STEP_AT steps of phase 6e's setup) and the same draws, PHD and CPHD
    arms, the resample forced (threshold 2): per-run log-likelihoods
    within MC_LOG_LIK_RTOL relative, resample picks within MAX_DIFFER of
    the particles."""
    import torch
    from phdslam_tpu_torch.eval import batch as B
    from phdslam_tpu_torch.filter.state import Measurements, SlamState
    from phdslam_tpu_torch.filter.step import draw_noise, run_scan, slam_step
    t0 = time.perf_counter()
    base, sc = mc_setup(MC_STEP_AT + 1)
    R, K = MC_STEP_RUNS, MC_STEP_AT
    base = base.replace(x0=float(sc.traj[0, 0]), y0=float(sc.traj[0, 1]),
                        yaw0=float(sc.traj[0, 2]))
    n = base.n_particles
    dts = np.full(K, base.dt, np.float32)
    one_run = lambda z, r: Measurements(rb=z.rb[r], label=z.label[r],
                                        valid=z.valid[r], count=z.count[r])
    for arm, over in MC_ARMS:
        cfg = base.replace(**over)
        ctrl, zs, gens = B.chunk_inputs(cfg, sc, range(R), 0,
                                        MC_CONTROL_NOISE, dev)
        state, _ = run_scan(SlamState.create(cfg, dev, n_runs=R), ctrl[:K],
                            zs[:K], dts, cfg, generator=gens)
        cfg_s = cfg.replace(resampleThresh=2.0)
        noise = draw_noise(cfg_s, R * n, dev, gens)
        c = torch.as_tensor(ctrl[K], device=dev)
        batch, aux = slam_step(state, (c[:, 0], c[:, 1]), zs[K],
                               float(cfg.dt), True, cfg_s, noise=noise,
                               z_prev=zs[K - 1])
        worst, n_diff = 0.0, 0
        for r in range(R):
            sl = slice(r * n, (r + 1) * n)
            alone, aux1 = slam_step(
                state.map(lambda t: t[sl]),
                (float(ctrl[K, r, 0]), float(ctrl[K, r, 1])),
                one_run(zs[K], r), float(cfg.dt), True, cfg_s,
                noise=(noise[0][:, sl], noise[1][sl]),
                z_prev=one_run(zs[K - 1], r))
            worst = max(worst, abs(float(aux.log_lik[r] - aux1.log_lik))
                        / abs(float(aux1.log_lik)))
            n_diff += int((batch.resample_idx[sl]
                           != alone.resample_idx).sum())
        log(f"one batched step, {arm}, {R} runs x {n} particles after {K} "
            f"steps: log_lik per run within {worst:.3e} relative of each "
            f"run alone (bar {MC_LOG_LIK_RTOL:g}); resample picks differing "
            f"{n_diff}/{R * n}")
        if not worst <= MC_LOG_LIK_RTOL:
            raise RuntimeError(f"one batched step, {arm}: log_lik off by "
                               f"{worst:.3e} relative")
        _limit(n_diff, R * n, f"one batched step, {arm}: resample picks")
    log(f"phase one batched step: ok ({time.perf_counter() - t0:.1f} s)")


def phase_mc_fastslam_mixed(dev, stats):
    """run_batch with cfg/fastslam_synth.cfg and cfg/mixed_synth.cfg,
    MC_SIDE_RUNS runs x MC_SIDE_STEPS steps of phase 6e's scenario,
    sequential and vmapped, counts from 0 before each: each kernel of the
    filter once per update step of each run (sequential) or once per step
    of the chunk (vmapped); every pose finite; the gap between the two
    paths' pose curves logged (their draws are the same)."""
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.eval import batch as B
    t0 = time.perf_counter()
    _, sc = mc_setup(MC_SIDE_STEPS)
    zero = dict(select=0, select_by_index=0, select4=0, select4_by_index=0,
                merge=0, merge4=0, merge3=0, esf=0, auction=0,
                ospa_auction=0, preupdate=0)
    for name, cfg_file, kernels in (
            ("FastSLAM", "cfg/fastslam_synth.cfg", ("auction", "preupdate")),
            ("mixed", "cfg/mixed_synth.cfg",
             ("select", "select4", "merge", "merge4", "preupdate"))):
        cfg = load_config(str(ROOT / cfg_file))
        n_seq, n_vm = update_steps(cfg, sc, range(MC_SIDE_RUNS))
        out = {}
        for vmapped, n_up in ((False, n_seq), (True, n_vm)):
            zero_launch_counts()
            res = B.run_batch(cfg, sc, MC_SIDE_RUNS,
                              control_noise=MC_CONTROL_NOISE,
                              collect_maps_every=MC_EVERY, vmapped=vmapped,
                              device=dev)
            check_launches(launch_counts(),
                           dict(zero, **{k: n_up for k in kernels}),
                           f"{name} {'vmapped' if vmapped else 'sequential'}")
            if not all(np.isfinite(r.poses).all() for r in res):
                raise RuntimeError(f"{name}: a pose is not finite")
            out[vmapped] = res
        gap = max(float(np.abs(a.poses[:, :2] - b.poses[:, :2]).max())
                  for a, b in zip(out[False], out[True]))
        err = [float(np.mean([r.pose_err.mean() for r in out[v]]))
               for v in (False, True)]
        ms = [float(np.mean([r.ms_per_step for r in out[v]]))
              for v in (False, True)]
        log(f"{name} run_batch {MC_SIDE_RUNS} runs x {sc.traj.shape[0]} "
            f"steps: vmapped launches per chunk-step, sequential per "
            f"run-step ({n_vm}, {n_seq} update steps); pose curves apart by "
            f"at most {gap:.3e} m; mean pose error sequential {err[0]:.4f}, "
            f"vmapped {err[1]:.4f} m; {ms[0]:.3f} / {ms[1]:.3f} ms per "
            f"run-step")
        stats[f"mc_{name.lower()}_pose_gap_m"] = gap
    log(f"phase FastSLAM and mixed batches: ok "
        f"({time.perf_counter() - t0:.1f} s)")


def device_busy(prof):
    """(device busy us: the union of the device's kernel and copy
    intervals, the profiled window in us, device activities)."""
    from torch.autograd import DeviceType
    events = prof.events()
    on_dev = sorted((e.time_range.start, e.time_range.end)
                    for e in events if e.device_type == DeviceType.CUDA)
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    busy, reach = 0.0, lo
    for a, b in on_dev:
        busy += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    return busy, hi - lo, len(on_dev)


def draws_cost(cfg, R, dev):
    """Log one step's random draws for R runs, each from its own generator
    (2R launches, the run axis' contract) and, for comparison, the same
    numbers from one generator (2 launches), host wall per step."""
    import torch
    from phdslam_tpu_torch.filter.step import draw_noise
    gens = [torch.Generator(device=dev).manual_seed(r) for r in range(R)]
    one = torch.Generator(device=dev).manual_seed(0)
    n = R * cfg.n_particles
    out = []
    for g in (gens, one):
        draw_noise(cfg, n, dev, g)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(TIMED):
            draw_noise(cfg, n, dev, g)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3 / TIMED)
    log(f"draws for {R} runs x {cfg.n_particles} particles: {out[0]:.3f} ms "
        f"a step from {R} generators, {out[1]:.3f} ms from one")


def phase_mc_fill(dev, stats, profile):
    """run_batch(vmapped=True) at JAX's default chunk (65536 // 256 = 256
    runs of 256 particles in one chunk) over the first MC_FILL_STEPS steps
    of phase 6e's scenario, PHD and CPHD arms: ms per run-step and the peak
    device memory, and the cost of the per-run draws at MC_RUNS and at the
    chunk's runs; with --profile, the device's busy share of PROFILED
    batched steps after PROFILE_WARMUP and the ops with the most device
    time."""
    import torch
    from phdslam_tpu_torch.eval import batch as B
    from phdslam_tpu_torch.filter.state import SlamState
    from phdslam_tpu_torch.filter.step import slam_step
    t0 = time.perf_counter()
    base, sc = mc_setup(MC_FILL_STEPS)
    R = MC_FILL_PARTICLES // base.n_particles
    for arm, over in MC_ARMS:
        cfg = base.replace(**over)
        reset_peak_memory()
        t_run = time.perf_counter()
        res = B.run_batch(cfg, sc, R, control_noise=MC_CONTROL_NOISE,
                          collect_maps_every=MC_EVERY, vmapped=True,
                          device=dev)
        run_s = time.perf_counter() - t_run
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = res[0].ms_per_step
        if not all(np.isfinite(r.poses).all() for r in res):
            raise RuntimeError(f"fill probe {arm}: a pose is not finite")
        pose = float(np.mean([r.pose_err.mean() for r in res]))
        log(f"fill probe {arm}: {R} runs x {cfg.n_particles} particles in "
            f"one chunk x {sc.traj.shape[0]} steps: {ms:.4f} ms per run-step "
            f"({ms * R:.2f} ms per chunk-step), peak device memory "
            f"{peak:.2f} GiB, mean pose error {pose:.4f} m, {run_s:.1f} s")
        stats[f"mc_fill_{arm.lower()}"] = dict(ms_per_run_step=ms,
                                               peak_gib=peak)
        if arm == MC_ARMS[0][0]:
            for n_runs in (MC_RUNS, R):
                draws_cost(cfg, n_runs, dev)
        if not profile:
            continue
        from torch.profiler import ProfilerActivity, profile as trace
        cfg = cfg.replace(x0=float(sc.traj[0, 0]), y0=float(sc.traj[0, 1]),
                          yaw0=float(sc.traj[0, 2]))
        ctrl, zs, gens = B.chunk_inputs(cfg, sc, range(R), 0,
                                        MC_CONTROL_NOISE, dev)
        state = SlamState.create(cfg, dev, n_runs=R)
        ctl = torch.as_tensor(ctrl, device=dev)

        def step(st, t):
            return slam_step(st, (ctl[t, :, 0], ctl[t, :, 1]), zs[t],
                             float(cfg.dt), t > 0, cfg, generator=gens,
                             z_prev=zs[t - 1] if t else None)[0]

        for t in range(PROFILE_WARMUP):
            state = step(state, t)
        torch.cuda.synchronize()
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for t in range(PROFILE_WARMUP, PROFILE_WARMUP + PROFILED):
                state = step(state, t)
            torch.cuda.synchronize()
        busy, window, n_act = device_busy(prof)
        busy_ms = busy / 1e3 / PROFILED
        # the profiler slows the host: the share of run_batch's chunk-step
        # (profiler off) is the one to read
        log(f"profile fill probe {arm}: device busy {busy_ms:.3f} ms per "
            f"chunk-step = {busy_ms / (ms * R):.1%} of run_batch's "
            f"{ms * R:.3f} ms (profiler off), {busy / window:.1%} of the "
            f"profiled window ({window / 1e3 / PROFILED:.3f} ms per "
            f"chunk-step); {n_act / PROFILED:.0f} device activities per step")
        stats[f"mc_fill_{arm.lower()}"]["busy_share"] = busy_ms / (ms * R)
        log_top_ops(prof)
    log(f"phase fill probe: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------- phase 6c: FastSLAM main path --

def fastslam_cell(dev):
    """scripts/fastslam_evidence.py's low-clutter cell, as the evidence
    entry point builds it: (cfg, scenario, controls, per-step Measurements
    on dev). The steps are driven directly, not through the loaders (which
    would drop a step without measurements and shift the rest)."""
    from phdslam_tpu_torch.evidence.fastslam import cell_config, cell_data
    from phdslam_tpu_torch.filter.state import Measurements
    cfg = cell_config(*FS_CELL, T=FS_STEPS, n_particles=FS_PARTICLES)
    sc, controls, rb, labels, valid = cell_data(cfg, *FS_CELL[:2],
                                                T=FS_STEPS)
    zs = [Measurements.from_numpy(rb[t], labels[t], valid[t], dev)
          for t in range(FS_STEPS)]
    return cfg, sc, controls, zs


def run_fastslam_cell(cell, seed, assoc, dev, tm):
    """The cell's FastSLAM run at filter seed `seed` and fastslamAssoc
    `assoc`, the launch counts set to 0 just before and read just after:
    (pose errors [T], launch counts, ms/step)."""
    import torch
    from contextlib import ExitStack

    from phdslam_tpu_torch.filter.state import SlamState
    from phdslam_tpu_torch.filter.step import slam_step
    cfg, sc, controls, zs = cell
    cfg = cfg.replace(fastslamAssoc=assoc)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = SlamState.create(cfg, dev)
    poses = []
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    with ExitStack() as stack:
        for t in tm.values():
            stack.enter_context(t)
        for t, z in enumerate(zs):
            u = ((float(controls[t - 1, 0]), float(controls[t - 1, 1]))
                 if t > 0 else (0.0, 0.0))
            state, aux = slam_step(state, u, z, float(cfg.dt), t > 0, cfg,
                                   generator=gen)
            poses.append(aux.expected_pose[:2])
        poses = torch.stack(poses).cpu().numpy()    # waits for the device
    ms = (time.perf_counter() - t0) * 1e3 / len(zs)
    launches = launch_counts()
    return (np.linalg.norm(poses - sc.traj[:len(zs), :2], axis=1), launches,
            ms)


def phase_fastslam_main_path(dev, stats):
    """The FastSLAM main path: the low-clutter cell at filter seed 0 with
    the auction (fastslamAssoc 1), its kernel against plain on the last
    launch; then the envelope over FS_SEEDS and gated ML (mode 0) at seed
    0."""
    t0 = time.perf_counter()
    cell = fastslam_cell(dev)
    n_update = sum(z.count > 0 for z in cell[3])
    none = dict(select=0, select_by_index=0, select4=0, select4_by_index=0,
                merge=0, merge4=0, merge3=0, esf=0)
    tm = {"auction": timers()["auction"]}
    errs, launches, ms = run_fastslam_cell(cell, 0, 1, dev, tm)
    check_launches(launches, dict(none, auction=n_update,
                                  preupdate=n_update),
                   "FastSLAM main path")
    agree_on_last_args(tm, stats, "FastSLAM main path")
    mean_it, max_it, at_budget = auction_rounds(
        tm["auction"].last_out[1], tm["auction"].last_args[0][2])
    log(f"FastSLAM main path (seed 0, auction): {FS_STEPS} steps, launches "
        f"{launches} (update steps {n_update}), pose error mean "
        f"{errs.mean():.4f} m max {errs.max():.4f} m, {ms:.3f} ms/step "
        f"(auction {tm['auction'].ms() / FS_STEPS:.4f} ms/step, CUDA "
        f"events); last launch's rounds per particle mean {mean_it:.2f} max "
        f"{max_it}, {at_budget} at the budget")
    stats["auction"]["launches"] = launches["auction"]
    stats["fastslam_ms_per_step"] = ms
    env = [float(errs.mean())]
    for seed in FS_SEEDS:
        if seed == 0:
            continue
        e, _, _ = run_fastslam_cell(cell, seed, 1, dev, {})
        env.append(float(e.mean()))
    e0, launches0, ms0 = run_fastslam_cell(cell, 0, 0, dev, {})
    check_launches(launches0, dict(none, auction=0, preupdate=n_update),
                   "FastSLAM gated ML")
    a = np.array(env)
    log(f"FastSLAM envelope (auction), pose error (m), seeds "
        f"{list(FS_SEEDS)}: " + ", ".join(f"{x:.4f}" for x in a)
        + f"; mean {a.mean():.4f}, std {a.std(ddof=1):.4f}")
    log(f"FastSLAM gated ML (fastslam_assoc 0), seed 0: pose error mean "
        f"{e0.mean():.4f} m max {e0.max():.4f} m, {ms0:.3f} ms/step, "
        f"auction launched {launches0['auction']} times")
    # gated ML is logged, not gated: the JAX package's record (the
    # robustness grid) holds the auction only
    if not (np.isfinite(a).all() and (a < FS_SEED_BAR_M).all()
            and a.mean() < FS_MEAN_BAR_M and np.isfinite(e0).all()):
        raise RuntimeError(f"FastSLAM: a seed's mean pose error is not "
                           f"below {FS_SEED_BAR_M} m, or their mean not "
                           f"below {FS_MEAN_BAR_M} m")
    log(f"phase FastSLAM main path: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------- phase 6d: FastSLAM runner --

def phase_fastslam_runner(dev, stats):
    """cfg/fastslam_synth.cfg as shipped (clutter 20, std_range 1.0)
    through the runner on the static phase's 330-step run, with --truth
    and --predict-time; the step-100 fixture replayed by `profile`; a
    short run with map_estimate 3 and --mat-export. Tracking is logged,
    not gated (FastSLAM diverges in this regime in the JAX package too)."""
    from phdslam_tpu_torch import runner
    from phdslam_tpu_torch.io.matdump import read_particles_mat
    t0 = time.perf_counter()
    cfg_text = (ROOT / "cfg/fastslam_synth.cfg").read_text()
    tm = timers()
    with tempfile.TemporaryDirectory() as d:
        sc, n_steps, start = static_run_files(d)
        truth = Path(d, "truth.txt")
        np.savetxt(truth, sc.landmarks)
        launches, run_s, out = run_runner(
            d, cfg_text, start, dev, tm,
            extra=("--truth", str(truth), "--predict-time"))
        loop_ms = np.loadtxt(out / "loopTime.log")
        pred_ms = np.loadtxt(out / "predicttime.log")
        metrics = [json.loads(x) for x in
                   (out / "metrics.jsonl").read_text().splitlines()]
        logs, errs = pose_errors(out, sc.traj, n_steps, 2)
        w = np.concatenate([lg["static"][:, 0] for lg in logs])
        ospa = np.array([m["ospa"][0] for m in metrics])
        log(f"FastSLAM runner (shipped cfg, clutter 20): {n_steps} steps, "
            f"launches {launches}, pose error mean {errs.mean():.3f} m max "
            f"{errs.max():.3f} m (not gated), OSPA first {ospa[0]:.3f} last "
            f"{ospa[-1]:.3f} mean {ospa.mean():.3f}, {loop_ms.mean():.3f} "
            f"ms/step (median {np.median(loop_ms):.3f}), prediction alone "
            f"{pred_ms.mean():.3f} ms, run {run_s:.1f} s")
        if len(logs) != n_steps or len(loop_ms) != n_steps \
                or len(metrics) != n_steps or len(pred_ms) != n_steps - 1 \
                or not (w == np.round(w)).all() \
                or not np.isfinite(ospa).all() \
                or not (out / "state100.pkl").exists():
            raise RuntimeError("FastSLAM runner: log contract incomplete")
        check_launches(launches, dict(
            auction=n_steps, select=0, select_by_index=0, select4=0,
            select4_by_index=0, merge=0, merge4=0, merge3=0, esf=0,
            preupdate=n_steps), "FastSLAM runner")
        agree_on_last_args(tm, stats, "FastSLAM runner")
        res = runner.main([str(Path(d, "run.cfg")), "synth", "profile",
                           "--out-dir", str(out), "--device", dev.type])
        log(f"FastSLAM profile replay of state100.pkl: "
            + ", ".join(f"{x:.3f}" for x in res["ms"]) + " ms")
        stats["fastslam_runner_ms_per_step"] = float(loop_ms.mean())
        # scan mode has no --predict-time (loop mode only); the loop run's
        # logs do not depend on it
        stats.setdefault("scan_ms_per_step", {})["FastSLAM"] = scan_as_loop(
            lambda: run_runner(d, cfg_text, start, dev, {}, mode="scan",
                               extra=("--truth", str(truth))), out,
            n_steps, dict(auction=n_steps, select=0, merge=0,
                          preupdate=n_steps), "FastSLAM runner")

        launches, run_s, out = run_runner(
            d, cfg_text, start + f"n_steps = {FS_SHORT_STEPS}\n"
            "map_estimate = 3\n", dev, {}, extra=("--mat-export",))
        mats = sorted(out.glob("particles0*.mat"))
        m = read_particles_mat(str(mats[-1]))
        n_exp = len(m["exp_map_static"]["weights"][0])
        n_max = len(m["max_map_static"]["weights"][0])
        logs, _ = pose_errors(out, sc.traj, FS_SHORT_STEPS, 2)
        log(f"FastSLAM runner, map_estimate 3 with --mat-export: "
            f"{len(mats)} .mat files, the last with {m['states'].shape[1]} "
            f"particles, an EAP map of {n_exp} and a MAP map of {n_max} "
            f"components; the last log's map {len(logs[-1]['static'])} "
            f"components, run {run_s:.1f} s")
        if len(mats) != FS_SHORT_STEPS or n_exp == 0 or n_max == 0 \
                or len(logs[-1]["static"]) != n_exp:
            raise RuntimeError("FastSLAM runner: .mat export or EAP map "
                               "incomplete")
    log(f"phase FastSLAM runner: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------ phases 7-9: dense steps --

def stress_cfg(shape, dense=True, cfg_file="cfg/ackerman_synth.cfg",
               **overrides):
    """A shipped cfg at a shape; dense adds the benchmark's dense-stress
    scene (phdslam_tpu_torch.bench.dense_overrides), then the given cfg
    overrides."""
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.bench import dense_overrides
    cfg = load_config(str(ROOT / cfg_file)).replace(
        n_particles=shape["P"], maxFeatures=shape["F"],
        maxMeasurements=shape["M"])
    if dense:
        cfg = dense_overrides(cfg)
    return cfg.replace(**overrides)


def stress_stream(cfg, n_steps, dev):
    """The benchmark's stress stream (phdslam_tpu_torch.bench.
    make_stress_inputs) as Measurements on dev, and the controls."""
    from phdslam_tpu_torch.bench import make_stress_inputs
    from phdslam_tpu_torch.filter.state import Measurements
    rb, valid, controls = make_stress_inputs(cfg, n_steps)
    label = np.zeros((cfg.maxMeasurements,), np.int32)
    return [Measurements.from_numpy(rb[t], label, valid[t], dev)
            for t in range(n_steps)], controls


def stress_stepper(shape, n_steps, dev, dense=True,
                   cfg_file="cfg/ackerman_synth.cfg", mesh=None,
                   **overrides):
    """(cfg, state, step(state, t)) for stress_cfg's cfg on the stress
    stream; with a mesh, the sharded step on the rank's rows (the same
    draws: every rank draws the global step's)."""
    import torch
    from phdslam_tpu_torch.filter.state import SlamState
    from phdslam_tpu_torch.filter.step import slam_step
    from phdslam_tpu_torch.parallel.mesh import shard_state

    cfg = stress_cfg(shape, dense, cfg_file, **overrides)
    zs, controls = stress_stream(cfg, n_steps, dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def step(state, t):
        return slam_step(state, (float(controls[t, 0]),
                                 float(controls[t, 1])), zs[t],
                         float(cfg.dt), t > 0, cfg, generator=gen,
                         z_prev=zs[t - 1] if t > 0 else None, mesh=mesh)

    state = SlamState.create(cfg, dev)
    return cfg, state if mesh is None else shard_state(state, mesh), step


def timed_steps(stats, state, step, warmup, what, shape, tm=None,
                peak=False):
    """warmup steps, then TIMED steps with CUDA events around the whole
    and around every kernel launch (glue is the remainder); logs the split
    (peak: and the peak device memory since the phase's reset_peak_memory,
    read before the checks) and checks every kernel against its plain
    version on the last timed step's own inputs (real pools hold exact
    weight ties, e.g. births of measurements no feature explains). Returns
    (state, ms/step)."""
    import torch
    from contextlib import ExitStack
    for t in range(warmup):
        state, aux = step(state, t)
    torch.cuda.synchronize()
    tm = timers() if tm is None else tm
    with ExitStack() as stack:
        for tmr in tm.values():
            stack.enter_context(tmr)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for t in range(warmup, warmup + TIMED):
            state, aux = step(state, t)
        end.record()
        torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / TIMED
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if peak:
        stats.setdefault("peak_gib", {})[what] = peak_gib
    k_ms = {k: t.ms() / TIMED for k, t in tm.items() if t.pairs}
    glue_ms = step_ms - sum(k_ms.values())
    neff = float(aux.neff)
    log(f"{what} {shape}: {step_ms:.3f} ms/step = pre-update and glue "
        f"{glue_ms:.3f} + " + " + ".join(
            f"{k} kernel {v:.3f}" for k, v in k_ms.items())
        + f" (neff {neff:.4f})"
        + (f"; peak device memory {peak_gib:.2f} GiB" if peak else ""))
    agree_on_last_args(tm, stats, what)
    if not np.isfinite(neff) or glue_ms < 0:
        raise RuntimeError(f"{what}: neff {neff}, glue {glue_ms} ms")
    return state, step_ms


def dense_run(dev, stats, cfg_file, what):
    _, state, step = stress_stepper(DENSE, WARMUP + TIMED, dev,
                                    cfg_file=cfg_file)
    state, step_ms = timed_steps(stats, state, step, WARMUP, what,
                                 f"{DENSE['P']}x{DENSE['F']}x{DENSE['M']}")
    live = int((state.map_static.w > 0).sum(1).max())
    live4 = int((state.map_dynamic.w > 0).sum(1).max()) \
        if state.map_dynamic.w.shape[1] else 0
    log(f"{what}: max live map slots {live} static, {live4} dynamic")
    return step_ms


def phase_dense(dev, stats, gpu):
    t0 = time.perf_counter()
    stats["dense_ms_per_step"] = dense_run(dev, stats,
                                           "cfg/ackerman_synth.cfg",
                                           "dense step")
    log(f"phase dense: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    stats["dense_mixed_ms_per_step"] = dense_run(dev, stats,
                                                 "cfg/mixed_synth.cfg",
                                                 "dense mixed step")
    log(f"dense timing on {gpu}: static step "
        f"{stats['dense_ms_per_step']:.3f} ms, mixed step "
        f"{stats['dense_mixed_ms_per_step']:.3f} ms")
    log(f"phase dense mixed: ok ({time.perf_counter() - t0:.1f} s)")


def disparity_stepper(shape, n_steps, dev, mesh=None):
    """(state, step(state, t)) of the disparity cfg widened to shape on the
    shipped measurement stream (data/disparity_synth/), with the runner's
    initial roll and yaw jitter; with a mesh, the sharded step on the
    rank's rows."""
    import torch
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.filter.disparity import (DisparityState,
                                                    disparity_step)
    from phdslam_tpu_torch.filter.state import Measurements
    from phdslam_tpu_torch.io import loaders
    from phdslam_tpu_torch.parallel.mesh import shard_state

    cfg = load_config(str(ROOT / "cfg/disparity_synth.cfg")).replace(
        n_particles=shape["P"], maxFeatures=shape["F"],
        maxMeasurements=shape["M"])
    sets = loaders.load_measurements(
        str(ROOT / "data/disparity_synth/measurements.txt"))[:n_steps]
    rb, labels, valid = loaders.pad_measurement_sets(sets,
                                                     cfg.maxMeasurements)
    zs = [Measurements.from_numpy(rb[t], labels[t], valid[t], dev)
          for t in range(len(sets))]
    gen = torch.Generator(device=dev).manual_seed(0)
    state = DisparityState.create(cfg, dev)
    jitter = torch.rand((cfg.n_particles, 2), generator=gen,
                        device=dev) * 0.06 - 0.03
    pose = state.pose.clone()
    pose[:, 3] += jitter[:, 0]
    pose[:, 5] += jitter[:, 1]

    def step(st, t):
        return disparity_step(st, zs[t], float(cfg.dt), t > 0, cfg,
                              generator=gen, mesh=mesh)

    state = state.replace(pose=pose)
    return state if mesh is None else shard_state(state, mesh), step


def phase_dense_cphd_disparity(dev, stats, gpu):
    """The two stress shapes of this slice (not shipped cfgs): CPHD at
    BASELINE config 3's shape and the disparity step at 8192 particles."""
    t0 = time.perf_counter()
    _, state, step = stress_stepper(
        DENSE_CPHD, WARMUP + TIMED, dev, filterType=1, maxCardinality=127,
        gateBirths=True, gateThreshold=9.0)
    state, ms = timed_steps(stats, state, step, WARMUP, "dense CPHD step",
                            "x".join(str(DENSE_CPHD[k]) for k in "PFM")
                            + " N+1=128")
    stats["dense_cphd_ms_per_step"] = ms
    log(f"dense CPHD step: max live map slots "
        f"{int((state.map_static.w > 0).sum(1).max())}")
    log(f"phase dense CPHD: ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    reset_peak_memory()
    state, step = disparity_stepper(DENSE_DISP, DISP_WARMUP + TIMED, dev)
    state, ms = timed_steps(stats, state, step, DISP_WARMUP,
                            "dense disparity step",
                            "x".join(str(DENSE_DISP[k]) for k in "PFM")
                            + " x 64 points", peak=True)
    stats["dense_disparity_ms_per_step"] = ms
    log(f"dense disparity step: max live map slots "
        f"{int((state.w > 0).sum(1).max())}")
    log(f"dense timing on {gpu}: CPHD step "
        f"{stats['dense_cphd_ms_per_step']:.3f} ms, disparity step "
        f"{stats['dense_disparity_ms_per_step']:.3f} ms")
    log(f"phase dense disparity: ok ({time.perf_counter() - t0:.1f} s)")


def phase_dense_fastslam(dev, stats, gpu):
    """The FastSLAM step at 8192 x 512 x 64 on the stress stream, from
    empty maps: FS_WARMUP steps fill them with counters the filter made,
    then TIMED steps split into glue and the auction."""
    t0 = time.perf_counter()
    reset_peak_memory()
    _, state, step = stress_stepper(DENSE_FS, FS_WARMUP + TIMED, dev,
                                    cfg_file="cfg/fastslam_synth.cfg")
    tm = timers()
    state, ms = timed_steps(stats, state, step, FS_WARMUP,
                            "dense FastSLAM step",
                            "x".join(str(DENSE_FS[k]) for k in "PFM"), tm,
                            peak=True)
    a, _ = tm["auction"].last_args
    mean_it, max_it, at_budget = auction_rounds(tm["auction"].last_out[1],
                                                a[2])
    live = (state.map_static.w > 0).sum(1).float()
    log(f"dense FastSLAM step: live slots per particle mean "
        f"{float(live.mean()):.1f} max {int(live.max())}; the last "
        f"launch's rounds per particle mean {mean_it:.2f} max {max_it}, "
        f"{at_budget} at the budget {a[2]}")
    stats["dense_fastslam_ms_per_step"] = ms
    log(f"dense timing on {gpu}: FastSLAM step {ms:.3f} ms")
    log(f"phase dense FastSLAM: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------ phases 6f and 9c: no host sync, islands --

def host_waits(fn):
    """fn() under torch.cuda.set_sync_debug_mode "warn": every operation
    that made the host wait for the device, as the port's line that called
    it ("file.py:line")."""
    import traceback

    import torch
    seen = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            port = [f for f in traceback.extract_stack()
                    if "phdslam_tpu_torch" in f.filename]
            f = port[-1] if port else None
            seen.append(f"{Path(f.filename).name}:{f.lineno}" if f
                        else f"{Path(filename).name}:{lineno}")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return seen


def sync_free(fn, what):
    """fn() under torch.cuda.set_sync_debug_mode "warn" (``host_waits``),
    then under "error"; raises if either run waited."""
    import torch
    seen = host_waits(fn)
    if seen:
        raise RuntimeError(f"{what}: the host waited for the device at "
                           + ", ".join(sorted(set(seen))))
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"{what}: no host sync (set_sync_debug_mode warn, then error)")


def phase_sync_free_batch(dev, stats):
    """6f: SYNC_RUNS runs of the static cfg at the shipped shape stepped
    together on the stress stream, run 1 without measurements at step 1
    (the per-run update gate) and so without CPHD births at step 2, PHD and
    CPHD arms: the three steps, after a warm-up pass, under sync_free."""
    import torch
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.bench import make_stress_inputs
    from phdslam_tpu_torch.filter.state import Measurements, SlamState
    from phdslam_tpu_torch.filter.step import slam_step
    t0 = time.perf_counter()
    R = SYNC_RUNS
    for arm, over in MC_ARMS:
        cfg = load_config(str(ROOT / "cfg/ackerman_synth.cfg")).replace(
            n_particles=SHIPPED["P"], maxFeatures=SHIPPED["F"],
            maxMeasurements=SHIPPED["M"], **over)
        rb, valid, controls = make_stress_inputs(cfg, 3)
        rb = np.repeat(rb[:, None], R, 1)
        valid = np.repeat(valid[:, None], R, 1)
        valid[1, 1] = False
        lab = np.zeros(valid.shape[1:], np.int32)
        zs = [Measurements.from_numpy(rb[t], lab, valid[t], dev)
              for t in range(3)]
        state0 = SlamState.create(cfg, dev, n_runs=R)
        gens = [torch.Generator(device=dev).manual_seed(r) for r in range(R)]

        def steps():
            st, prev = state0, None
            for t, z in enumerate(zs):
                st, aux = slam_step(st, (float(controls[t, 0]),
                                         float(controls[t, 1])), z,
                                    float(cfg.dt), t > 0, cfg,
                                    generator=gens, z_prev=prev)
                prev = z
            return aux

        steps()
        sync_free(steps, f"batched step, {arm}, {R} runs x "
                  f"{cfg.n_particles} particles, run 1 without "
                  "measurements at step 1")
    log(f"phase no host sync: ok ({time.perf_counter() - t0:.1f} s)")


def island_stepper(shape, n_steps, dev, n_islands, thresh, mesh=None):
    """(cfg, state, step(state, t), run) of the island step: the static
    cfg at a shape with bench.py's dense overrides on the stress stream,
    as stress_stepper's; run holds the island log-weights and the last
    IslandAux; step returns the state and an object whose neff is the
    island nEff (timed_steps reads it); with a mesh, across its ranks (the
    state the rank's islands)."""
    import torch
    from types import SimpleNamespace

    from phdslam_tpu_torch.parallel.island import (init_islands,
                                                   island_slam_step)
    from phdslam_tpu_torch.parallel.mesh import shard_state
    cfg = stress_cfg(shape)
    zs, controls = stress_stream(cfg, n_steps, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, ilw = init_islands(cfg, n_islands, dev)
    run = SimpleNamespace(ilw=ilw, aux=None)

    def step(st, t):
        st, run.ilw, run.aux = island_slam_step(
            st, run.ilw, (float(controls[t, 0]), float(controls[t, 1])),
            zs[t], float(cfg.dt), t > 0, cfg, n_islands, thresh=thresh,
            generator=gen, z_prev=zs[t - 1] if t > 0 else None, mesh=mesh)
        return st, SimpleNamespace(neff=run.aux.island_neff)

    if mesh is not None:
        state = shard_state(state, mesh)
    return cfg, state, step, run


def phase_islands(dev, stats, gpu):
    """9c: the island step at the dense shape, ISLANDS islands of DENSE's
    P / ISLANDS particles, once never exchanging (threshold 0) and once
    always (1.1), each after the plain dense step, the three in that order
    ISLAND_ROUNDS times (host-bound times drift within a call): WARMUP
    steps, TIMED timed with CUDA events and split into glue, select and
    merge, the peak device memory, select and merge against plain on the
    last step's inputs; for the island steps the exchange alone on that
    step's state with its trigger on and off, and in the first round one
    more step under sync_free."""
    import torch
    from phdslam_tpu_torch.parallel.island import (butterfly_exchange,
                                                   draw_island_noise)
    t0 = time.perf_counter()
    shape = "x".join(str(DENSE[k]) for k in "PFM")
    p = DENSE["P"] // ISLANDS
    ms = {k: [] for k in ("plain",) + ISLAND_THRESHOLDS}
    ex = {k: [] for k in ISLAND_THRESHOLDS}
    for r in range(ISLAND_ROUNDS):
        reset_peak_memory()
        _, state, step = stress_stepper(DENSE, WARMUP + TIMED, dev)
        ms["plain"].append(timed_steps(stats, state, step, WARMUP,
                                       "plain dense step", shape,
                                       peak=True)[1])
        for thresh in ISLAND_THRESHOLDS:
            reset_peak_memory()
            what = f"dense island step ({ISLANDS} x {p}, threshold {thresh})"
            cfg, state, step, run = island_stepper(
                DENSE, WARMUP + TIMED + 1, dev, ISLANDS, thresh)
            state, step_ms = timed_steps(stats, state, step, WARMUP, what,
                                         shape, peak=True)
            if bool(run.aux.exchanged) != (thresh > 1.0):
                raise RuntimeError(
                    f"{what}: exchanged {bool(run.aux.exchanged)} at island "
                    f"nEff {float(run.aux.island_neff)}")
            lse = float(torch.logsumexp(run.ilw, 0))
            if abs(lse) > 1e-5:
                raise RuntimeError(f"{what}: island weights' logsumexp "
                                   f"{lse}")
            u = draw_island_noise(cfg, ISLANDS, dev)[2]
            alone = []
            for trig in (True, False):
                on = torch.tensor(trig, device=dev)
                alone.append(cuda_ms(lambda: butterfly_exchange(
                    state, run.ilw, u, on, ISLANDS), TIMED))
            if r == 0:
                sync_free(lambda: step(state, WARMUP + TIMED), what)
            ms[thresh].append(step_ms)
            ex[thresh].append(alone)
            log(f"{what}, round {r + 1}: {step_ms:.3f} ms/step, the exchange"
                f" alone (3 rounds, one gather of the state) "
                f"{alone[0]:.4f} ms, its trigger off {alone[1]:.4f} ms; "
                f"island nEff {float(run.aux.island_neff):.4f}")
    fmt = lambda v: ", ".join(f"{x:.3f}" for x in v)
    log(f"dense timing on {gpu}, rounds of (plain, island threshold 0, "
        f"island threshold 1.1): plain dense step {fmt(ms['plain'])} ms; "
        f"island step ({ISLANDS} islands x {p}) never exchanging "
        f"{fmt(ms[0.0])} ms, always {fmt(ms[1.1])} ms; the exchange alone "
        + "; ".join(f"on the threshold-{k} state {fmt(sum(v, []))} ms "
                    "(trigger on, off per round)" for k, v in ex.items())
        + f" (phase 7: {stats['dense_ms_per_step']:.3f} ms)")
    log(f"phase dense islands: ok ({time.perf_counter() - t0:.1f} s)")


def phase_island_runner(dev, stats, d):
    """9c: the runner with --islands RUNNER_ISLANDS and --truth on the
    shipped static cfg over phase 3's run, loop and scan mode, launch
    counts from 0 before each: the log contract (a log, a loop time and
    a metrics line with ospa per step; every particle in each log; finite
    poses), select and merge once per update step, the island weights
    normalised within 1e-5, each island's local weights (loop) or the
    global weights (scan) summing to 1 within 1e-3; ms/step, mean pose
    error and exchanges beside phase 3's plain run, the pose error not
    gated (the reference's butterfly pool-mass defect applies here too).
    The run files and the runs' outputs (islands_loop, islands_scan) stay
    in d for phase 9d."""
    import torch
    t0 = time.perf_counter()
    tm = timers()
    n = RUNNER_ISLANDS
    sc, n_steps, start = static_run_files(d)
    Path(d, "run.cfg").write_text(
        (ROOT / "cfg/ackerman_synth.cfg").read_text() + start)
    truth = Path(d, "truth.txt")
    np.savetxt(truth, sc.landmarks)
    P = None
    for mode in ("loop", "scan"):
        out = Path(d, f"islands_{mode}")
        launches, run_s, res = run_cli(runner_args(
            d, out, dev, extra=("--mode", mode, "--islands", str(n),
                                "--truth", str(truth))), tm)
        logs, errs = pose_errors(out, sc.traj, n_steps, 2)
        loop_ms = np.loadtxt(out / "loopTime.log")
        with open(out / "metrics.jsonl") as f:
            metrics = [json.loads(line) for line in f]
        P = logs[0]["weights"].shape[0]
        if len(loop_ms) != n_steps or len(metrics) != n_steps \
                or not all("ospa" in m for m in metrics) \
                or any(lg["poses"].shape != (P, 6) for lg in logs):
            raise RuntimeError(f"islands {mode}: log contract incomplete")
        if not np.isfinite(errs).all():
            raise RuntimeError(f"islands {mode}: a pose is not finite")
        check_launches(launches, dict(select=n_steps, merge=n_steps,
                                      select_by_index=0, select4=0,
                                      select4_by_index=0, merge4=0,
                                      merge3=0, esf=0, auction=0,
                                      preupdate=n_steps),
                       f"islands {mode}")
        if mode == "loop":
            ilw = res["island_logw"][None]
            sums = np.stack([np.exp(lg["weights"].astype(
                np.float64)).reshape(n, -1).sum(1) for lg in logs[1:]])
            exchanges = sum(m["resampled"] for m in metrics)
        else:
            ilw = res["aux"].island_logw
            sums = np.array([np.exp(lg["weights"].astype(
                np.float64)).sum() for lg in logs])
            exchanges = sum(m["exchanged"] for m in metrics)
        lse = float(torch.logsumexp(ilw, -1).abs().max())
        if lse > 1e-5 or np.abs(sums - 1.0).max() > 1e-3:
            raise RuntimeError(f"islands {mode}: island weights' "
                               f"logsumexp {lse}, weight sums off by "
                               f"{np.abs(sums - 1.0).max()}")
        ospa = np.array([m["ospa"][0] for m in metrics])
        log(f"islands {mode} ({n} x {P // n}): {n_steps} steps, "
            f"launches {launches}, {loop_ms.mean():.3f} ms/step (median "
            f"{np.median(loop_ms):.3f}; plain run, phase 3: "
            f"{stats['shipped_ms_per_step']:.3f}), pose error mean "
            f"{errs.mean():.3f} m max {errs.max():.3f} m (plain "
            f"{stats['shipped_pose_err']:.3f}), exchanges {exchanges}, "
            f"OSPA last half {ospa[n_steps // 2:].mean():.4f}, island "
            f"weights' |logsumexp| <= {lse:.1e}, weight sums within "
            f"{np.abs(sums - 1.0).max():.1e} of 1, run {run_s:.1f} s")
    log(f"phase island runner: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------ phase 9d: the mesh --

def tree_tensors(obj, prefix=""):
    """Every tensor of a tree of NamedTuples, dataclasses, tuples and
    lists, keyed by its path."""
    import dataclasses

    import torch
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    out = {}
    if dataclasses.is_dataclass(obj):
        items = [(f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj)]
    elif hasattr(obj, "_asdict"):
        items = list(obj._asdict().items())
    elif isinstance(obj, (tuple, list)):
        items = list(enumerate(obj))
    else:
        items = []
    for k, v in items:
        out.update(tree_tensors(v, f"{prefix}.{k}"))
    return out


def same_bits(ref, got, what):
    """Raise unless every tensor of got has ref's shape, dtype and bits
    (float32 compared as int32, so NaNs and signed zeros count)."""
    import torch
    a, b = tree_tensors(ref), tree_tensors(got)
    if sorted(a) != sorted(b):
        raise RuntimeError(f"{what}: outputs differ in their fields")
    bits = lambda t: t.contiguous().view(torch.int32) \
        if t.dtype == torch.float32 else t
    for k in a:
        if a[k].shape != b[k].shape or a[k].dtype != b[k].dtype \
                or not torch.equal(bits(a[k]), bits(b[k])):
            raise RuntimeError(f"{what}: {k} differs from the single "
                               "process")


def mesh_pair(make, n_steps, mesh, what):
    """make(mesh) -> (state, step(state, t)). The sharded run (launch
    counts and the mesh's traffic record from 0; timed on the host clock,
    ending in a synchronise, from step 0), then the single-process run
    (make(None)), n_steps steps each from step 0: every aux and the final
    global state bit for bit, and the same launches, some kernel
    launched. Returns (the launches, the sharded run's traffic record,
    its ms a step)."""
    import torch
    from phdslam_tpu_torch.parallel.mesh import unshard_state

    def run(m):
        state, step = make(m)
        zero_launch_counts()
        if m is not None:
            m.take_traffic()
        auxs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n_steps):
            state, aux = step(state, t)
            auxs.append(aux)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_steps
        return state, auxs, launch_counts(), m and m.take_traffic(), ms

    state, auxs, launches, moved, ms = run(mesh)
    state = unshard_state(state, mesh)
    p_state, p_auxs, p_launches, _, _ = run(None)
    same_bits((p_auxs, p_state), (auxs, state), what)
    if launches != p_launches or not any(launches.values()):
        raise RuntimeError(f"{what}: launches {launches}, the single "
                           f"process's {p_launches}")
    log(f"{what}: {n_steps} steps bit for bit with the single process "
        "(every aux value and state leaf), launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f"; {ms:.3f} ms a step (host clock, from step 0); a step: "
        + traffic_line(moved, n_steps))
    return launches, moved, ms


def traffic_line(moved, n_steps):
    """A traffic record over n_steps steps, a step: each op and label's
    calls, MB this rank offered and received, its largest block."""
    return "; ".join(
        f"{k} {v['calls'] / n_steps:g} calls, offered "
        f"{v['offered'] / n_steps / 1e6:.6f} MB, received "
        f"{v['received'] / n_steps / 1e6:.6f} MB, largest block "
        f"{v['largest'] / 1e6:.6f} MB" for k, v in sorted(moved.items()))


def check_moved(moved, n_steps, what, read, gated, calls, small):
    """Raise unless the traffic record of n_steps steps holds one ``read``
    ("read_flag label") a step, the transfer it gates (``gated``, "op
    label") ``calls`` times a step (0: never), and no other block above
    ``small`` bytes. Returns the gated transfer's bytes received a
    step."""
    reads = moved.get(read, {}).get("calls")
    got = moved.get(gated, {}).get("calls", 0)
    big = {k: v["largest"] for k, v in moved.items()
           if k != gated and v["largest"] > small}
    if reads != n_steps or got != calls * n_steps or big:
        raise RuntimeError(f"{what}: {reads} reads in {n_steps} steps, "
                           f"{got} {gated} calls, blocks above {small} B "
                           f"{big}")
    return moved.get(gated, {}).get("received", 0) / n_steps


def scan_inputs(run_dir, cfg, dev, n_steps=None):
    """The run files in run_dir as the runner's scan mode feeds run_scan
    (its schedule, padded to cfg's measurements), the first n_steps steps
    (all by default): (controls, Measurements on dev, dts)."""
    from phdslam_tpu_torch import runner
    from phdslam_tpu_torch.io import loaders
    sets = loaders.load_measurements(str(Path(run_dir, "measurements.txt")))
    controls = loaders.load_controls(str(Path(run_dir, "controls.txt")))
    sets = sets[:n_steps or len(sets)]
    rb, labels, valid = loaders.pad_measurement_sets(sets,
                                                     cfg.maxMeasurements)
    steps = runner._step_inputs(runner.schedule_inputs(len(sets), None,
                                                       None),
                                controls, rb, labels, valid, cfg, dev)
    return tuple([s[i] for s in steps] for i in range(3))


def mesh_scan(dev, mesh, run_dir):
    """sharded_run_scan over phase 3's run (the files in run_dir) at its
    256 particles against run_scan on the same draws, bit for bit; the
    mean pose error below POSE_BAR_M. Returns (launches, the error)."""
    import torch
    from phdslam_tpu_torch import load_config, simdata
    from phdslam_tpu_torch.filter.state import SlamState
    from phdslam_tpu_torch.filter.step import run_scan
    from phdslam_tpu_torch.parallel.mesh import (shard_state,
                                                 sharded_run_scan,
                                                 unshard_state)
    cfg = load_config(str(Path(run_dir, "run.cfg")))
    ctrls, zs, dts = scan_inputs(run_dir, cfg, dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)
    what = (f"sharded_run_scan ({mesh.world_size} {mesh.backend} ranks x "
            f"{cfg.n_particles // mesh.world_size})")
    zero_launch_counts()
    state, auxs = sharded_run_scan(cfg, mesh)(
        shard_state(SlamState.create(cfg, dev), mesh), ctrls, zs, dts,
        generator=gen())
    torch.cuda.synchronize()
    launches = launch_counts()
    state = unshard_state(state, mesh)
    p_state, p_auxs = run_scan(SlamState.create(cfg, dev), ctrls, zs, dts,
                               cfg, generator=gen())
    same_bits((p_auxs, p_state), (auxs, state), what)
    traj = simdata.make_scenario(np.random.default_rng(0),
                                 n_steps=RUN_STEPS).traj
    poses = auxs.expected_pose.cpu().numpy()
    err = float(np.linalg.norm(poses[:, :2] - traj[:len(poses), :2],
                               axis=1).mean())
    log(f"{what} over phase 3's {len(zs)} steps: bit for bit with run_scan "
        f"(every aux value and the final state), launches select "
        f"{launches['select']} merge {launches['merge']}, mean pose error "
        f"{err:.3f} m")
    if launches["select"] != len(zs) or launches["merge"] != len(zs) \
            or launches["preupdate"] != len(zs) or not err < POSE_BAR_M:
        raise RuntimeError(f"{what}: launches {launches}, pose error {err}")
    return launches, err


def mesh_side_paths(dev, mesh):
    """The other filters through the mesh, MESH_SIDE_STEPS steps each, bit
    for bit against the single process: {path: launches}."""
    cphd = dict(filterType=1, maxCardinality=127, gateBirths=True,
                gateThreshold=9.0)
    cases = (
        ("CPHD", DENSE_CPHD, lambda m: stress_stepper(
            DENSE_CPHD, MESH_SIDE_STEPS, dev, mesh=m, **cphd)[1:]),
        ("mixed", SHIPPED, lambda m: stress_stepper(
            SHIPPED, MESH_SIDE_STEPS, dev, False, "cfg/mixed_synth.cfg",
            mesh=m)[1:]),
        ("FastSLAM", SHIPPED, lambda m: stress_stepper(
            SHIPPED, MESH_SIDE_STEPS, dev, False, "cfg/fastslam_synth.cfg",
            mesh=m)[1:]),
        ("disparity", None, lambda m: disparity_stepper(
            dict(P=64, F=64, M=48), MESH_SIDE_STEPS, dev, mesh=m)))
    out = {}
    for name, shape, make in cases:
        dims = "cfg/disparity_synth.cfg" if shape is None \
            else "x".join(str(shape[k]) for k in "PFM")
        out[name] = mesh_pair(make, MESH_SIDE_STEPS, mesh,
                              f"sharded {name} step {dims} "
                              f"({mesh.world_size} {mesh.backend} ranks)")[0]
    return out


def row_layouts(dev):
    """torch's per-row cumsum and sum on the card at the dense island
    pools (8 rows of 2048 uniform weights, 4 of 4096): rows taken 1, 2 and
    4 at a time alone against the same rows among all; the floats that
    differ alone are logged, and none may differ as among all
    (ops/resample.py's ``among``, the island step's ``layout_runs``).
    Then CUMSUM_CALLS cumsums of the same weights at CUMSUM_SIZES, one
    row and as the first of two rows: the distinct results of each are
    logged, and the two-row form (the resample's, F9) must give one."""
    import torch
    from phdslam_tpu_torch.ops.resample import among
    gen = torch.Generator(device=dev).manual_seed(5)
    fns = dict(cumsum=lambda v: torch.cumsum(v, 1),
               sum=lambda v: v.sum(1),
               logsumexp=lambda v: torch.logsumexp(v, 1))
    parts = []
    for n, width in ((8, 2 * DENSE["P"] // 8), (4, 2 * DENSE["P"] // 4)):
        x = torch.rand((n, width), generator=gen, device=dev) / width
        for name, fn in fns.items():
            full = fn(x)
            for q in (1, 2, 4):
                if q >= n:
                    continue
                part = x[:q].contiguous()
                alone = int((fn(part) != full[:q]).sum())
                laid = int((among(fn, part, n) != full[:q]).sum())
                if laid:
                    raise RuntimeError(f"{name} of {q} of {n} rows of "
                                       f"{width}: {laid} floats differ as "
                                       "among all")
                parts.append(f"{name} [{q} of {n}, {width}] {alone}")
    log("rows alone against the same rows among all, floats that differ "
        "(none as among all): " + ", ".join(parts))
    # F9: one row's CUDA cumsum (CUB's device scan) need not repeat itself;
    # the resample scans one run as the first of two rows, which must
    parts = []
    for n in CUMSUM_SIZES:
        w = torch.rand((1, n), generator=gen, device=dev)
        w = w / w.sum()
        two = w.repeat(2, 1)
        counts = []
        for fn in (lambda: torch.cumsum(w, 1),
                   lambda: torch.cumsum(two, 1)[:1]):
            outs = [fn() for _ in range(CUMSUM_CALLS)]
            distinct = []
            for o in outs:
                if not any(torch.equal(o, u) for u in distinct):
                    distinct.append(o)
            counts.append(len(distinct))
        if counts[1] != 1:
            raise RuntimeError(f"cumsum of {n} floats as the first of two "
                               f"rows: {counts[1]} distinct results")
        parts.append(f"{n} floats {counts[0]} / {counts[1]}")
    log(f"distinct results of {CUMSUM_CALLS} CUDA cumsums of the same "
        "weights, one row / as the first of two rows (must be 1): "
        + ", ".join(parts))


def mesh_dense_pairs(dev, mesh):
    """The dense static step through the mesh at MESH_THRESHOLDS (never,
    always resampling), each against the single process (``mesh_pair``):
    select and merge once a step, one read_flag a step, the state's leaves
    gathered on the firing steps only. Returns {threshold: MB received a
    step by the resample's gather}."""
    from phdslam_tpu_torch.filter.state import SlamState
    W = mesh.world_size
    n_leaves = len(tree_tensors(SlamState.create(
        stress_cfg(DENSE).replace(n_particles=1))))
    out = {}
    for thresh in MESH_THRESHOLDS:
        what = (f"dense sharded step ({W} {mesh.backend} ranks x "
                f"{DENSE['P'] // W}, threshold {thresh})")
        launches, moved, _ = mesh_pair(
            lambda m: stress_stepper(DENSE, MESH_STEPS, dev, mesh=m,
                                     resampleThresh=thresh)[1:],
            MESH_STEPS, mesh, what)
        check_launches(launches, dict(select=MESH_STEPS, merge=MESH_STEPS,
                                      preupdate=MESH_STEPS), what)
        out[thresh] = check_moved(
            moved, MESH_STEPS, what, "read_flag resample",
            "gather_rows resample", n_leaves if thresh > 1.0 else 0,
            DENSE["P"] // W * 6 * 4) / 1e6
    return out


def mesh_island_pairs(dev, mesh):
    """The dense island step across the mesh at MESH_ISLANDS islands and
    MESH_THRESHOLDS (never, always exchanging), each against the
    one-device island step (``mesh_pair``; the aux and the island
    weights): select and merge once a step, one read_flag a step, log2(W)
    exchange_rows calls a step when it exchanges, nothing else above [n/W,
    6] floats. Returns {"n threshold": MB received a step by the
    butterfly}."""
    W = mesh.world_size
    out = {}
    for n in MESH_ISLANDS:
        for thresh in MESH_THRESHOLDS:
            what = (f"dense island step ({n} x {DENSE['P'] // n} on {W} "
                    f"{mesh.backend} ranks, threshold {thresh})")

            def make(m):
                _, state, step, run = island_stepper(
                    DENSE, MESH_STEPS, dev, n, thresh, mesh=m)

                def pair_step(st, t):
                    st, _ = step(st, t)
                    return st, (run.aux, run.ilw)

                return state, pair_step

            launches, moved, _ = mesh_pair(make, MESH_STEPS, mesh, what)
            check_launches(launches, dict(select=MESH_STEPS,
                                          merge=MESH_STEPS,
                                          preupdate=MESH_STEPS), what)
            out[f"{n} {thresh}"] = check_moved(
                moved, MESH_STEPS, what, "read_flag butterfly",
                "exchange_rows butterfly",
                W.bit_length() - 1 if thresh > 1.0 else 0,
                n // W * 6 * 4) / 1e6
    return out


def _mesh_rank(rank, world, device, tmp, run_dir, ports):
    """Phase 9d (b) and (c) in one of MESH_RANKS spawned processes, all on
    the parent's device; writes its readings to tmp/rank<r>.json."""
    import os

    import torch
    from phdslam_tpu_torch.parallel.mesh import make_mesh
    global LOG_PREFIX
    LOG_PREFIX = f"[rank {rank}/{world}] "
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    stats, out = {}, dict(rank=rank)
    mesh = make_mesh("gloo", dev, rank=rank, world_size=world,
                     init_method=f"file://{Path(tmp, 'rdv_gloo')}")
    try:
        shape = "x".join(str(DENSE[k]) for k in "PFM")
        what = (f"dense sharded step ({world} gloo ranks x "
                f"{DENSE['P'] // world})")
        out["dense_mb"] = mesh_dense_pairs(dev, mesh)
        out["island_mb"] = mesh_island_pairs(dev, mesh)
        reset_peak_memory()
        _, state, step = stress_stepper(DENSE, WARMUP + TIMED, dev,
                                        mesh=mesh)
        what += ", two processes sharing one card through gloo, not a " \
            "multi-GPU figure"
        _, out["dense_ms"] = timed_steps(stats, state, step, WARMUP, what,
                                         shape, peak=True)
        out["dense_peak_gib"] = stats["peak_gib"][what]
        out["side"] = mesh_side_paths(dev, mesh)
        out["scan_launches"], out["scan_err"] = mesh_scan(dev, mesh,
                                                          run_dir)
        out["config5"] = config5_mesh_scans(dev, mesh, run_dir)
        out["disp"] = mesh_dense_disparity(dev, mesh)
    finally:
        mesh.close()
    truth = str(Path(run_dir, "truth.txt"))
    for mode, port in zip(("loop", "scan"), ports):
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK="0", MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
        launches, run_s, _ = run_cli(runner_args(
            run_dir, Path(run_dir, f"mesh_{mode}"), dev, extra=(
                "--mode", mode, "--islands", str(RUNNER_ISLANDS), "--truth",
                truth, "--dist-backend", "gloo")), timers())
        log(f"runner --islands {RUNNER_ISLANDS} --mode {mode} on {world} "
            f"gloo ranks: launches {launches}, run {run_s:.1f} s")
        out[f"runner_{mode}"] = dict(launches=launches, run_s=run_s)
    out["max_abs_err"] = {k: v["max_abs_err"] for k, v in stats.items()
                          if "max_abs_err" in v}
    Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))


def free_ports(n):
    """n distinct free TCP ports on localhost."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("localhost", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def same_run_outputs(one, two, what):
    """Every file of the run in one is in two with the same bytes,
    metrics.jsonl apart from its ms column and loopTime.log (times) in its
    line count."""
    names = sorted(p.name for p in Path(one).iterdir())
    if names != sorted(p.name for p in Path(two).iterdir()):
        raise RuntimeError(f"{what}: the runs wrote different files")
    for name in names:
        a, b = Path(one, name), Path(two, name)
        if name == "loopTime.log":
            ok = len(a.read_text().split()) == len(b.read_text().split())
        elif name == "metrics.jsonl":
            rows = [[{k: v for k, v in json.loads(line).items()
                      if k != "ms"} for line in p.read_text().splitlines()]
                    for p in (a, b)]
            ok = rows[0] == rows[1]
        else:
            ok = a.read_bytes() == b.read_bytes()
        if not ok:
            raise RuntimeError(f"{what}: {name} differs from the one-card "
                               "run")
    return len(names)


def one_read_a_step(fn, what):
    """fn() (one sharded step) under set_sync_debug_mode "warn": the host
    waits for the device exactly once, in parallel/mesh.py (read_flag)."""
    seen = host_waits(fn)
    if len(seen) != 1 or not seen[0].startswith("mesh.py:"):
        raise RuntimeError(f"{what}: the host waited for the device at "
                           f"{seen}, not once at read_flag")
    log(f"{what}: one host read a step, at {seen[0]} (read_flag; "
        "set_sync_debug_mode warn)")


def phase_mesh(dev, stats, gpu, run_dir):
    """9d: the row layouts, (a) in this process, (b) and (c) in
    MESH_RANKS spawned processes (``_mesh_rank``); then (c)'s outputs
    against phase 9c's."""
    import torch
    import torch.multiprocessing as mp
    from phdslam_tpu_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    row_layouts(dev)
    shape = "x".join(str(DENSE[k]) for k in "PFM")
    what = "dense sharded step (1 NCCL rank)"
    with tempfile.TemporaryDirectory() as tmp:
        mesh = make_mesh(device=dev, rank=0, world_size=1,
                         init_method=f"file://{Path(tmp, 'rdv_nccl')}")
        try:
            if mesh.backend != ("nccl" if dev.type == "cuda" else "gloo"):
                raise RuntimeError(f"{what}: backend {mesh.backend}")
            mesh_dense_pairs(dev, mesh)
            ms = {(k, t): [] for k in ("plain", "mesh")
                  for t in MESH_THRESHOLDS}
            for r in range(ISLAND_ROUNDS):
                for thresh in MESH_THRESHOLDS:
                    for kind in ("plain", "mesh"):
                        m = mesh if kind == "mesh" else None
                        label = (what if m else "plain dense step") \
                            + f", threshold {thresh}"
                        reset_peak_memory()
                        _, state, step = stress_stepper(
                            DENSE, WARMUP + TIMED + 1, dev, mesh=m,
                            resampleThresh=thresh)
                        state, step_ms = timed_steps(
                            stats, state, step, WARMUP, label, shape,
                            peak=True)
                        ms[kind, thresh].append(step_ms)
                        if m is not None and r == 0:
                            one_read_a_step(
                                lambda: step(state, WARMUP + TIMED), label)
            stats["config5_mesh"] = {"1 NCCL": config5_mesh_scans(
                dev, mesh, run_dir)}
            stats["disp_mesh"] = {"1 NCCL": mesh_dense_disparity(
                dev, mesh)}
            disp = "x".join(str(DENSE_DISP[k]) for k in "PFM") \
                + " x 64 points"
            for m in (None, mesh):
                reset_peak_memory()
                state, step = disparity_stepper(
                    DENSE_DISP, DISP_WARMUP + TIMED, dev, mesh=m)
                label = "dense sharded disparity step (1 NCCL rank)" if m \
                    else "plain dense disparity step"
                stats.setdefault("disp_mesh_ms", {})[label] = timed_steps(
                    stats, state, step, DISP_WARMUP, label, disp,
                    peak=True)[1]
        finally:
            mesh.close()
        fmt = lambda v: ", ".join(f"{x:.3f}" for x in v)
        log(f"dense timing on {gpu}, rounds of (plain, sharded) at "
            "thresholds " + ", ".join(map(str, MESH_THRESHOLDS)) + ": "
            + "; ".join(f"{k} threshold {t} {fmt(v)} ms"
                        for (k, t), v in ms.items()))
        stats["mesh_nccl_ms"] = {t: ms["mesh", t] for t in MESH_THRESHOLDS}

        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        mp.spawn(_mesh_rank, args=(MESH_RANKS, str(dev), tmp, str(run_dir),
                                   free_ports(2)),
                 nprocs=MESH_RANKS, join=True)
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(MESH_RANKS)]
    n_steps = len(np.loadtxt(Path(run_dir, "islands_loop", "loopTime.log")))
    for r in ranks:
        for k, err in r["max_abs_err"].items():
            _new_stats(stats, k)
            _err(stats, k, err)
        for mode in ("loop", "scan"):
            check_launches(r[f"runner_{mode}"]["launches"],
                           dict(select=n_steps, merge=n_steps,
                                select_by_index=0, select4=0,
                                select4_by_index=0, merge4=0, merge3=0,
                                esf=0, auction=0, preupdate=n_steps),
                           f"rank {r['rank']} runner {mode}")
    for mode in ("loop", "scan"):
        n_files = same_run_outputs(Path(run_dir, f"islands_{mode}"),
                                   Path(run_dir, f"mesh_{mode}"),
                                   f"runner --islands {mode} on "
                                   f"{MESH_RANKS} gloo ranks")
        log(f"runner --islands {RUNNER_ISLANDS} --mode {mode} on "
            f"{MESH_RANKS} gloo ranks: its {n_files} files equal phase "
            "9c's one-card run's (every state_estimate log byte for byte)")
    log(f"mesh timing on {gpu}: {what} " + "; ".join(
        f"threshold {t} {fmt(v)} ms" for t, v in
        stats["mesh_nccl_ms"].items())
        + f"; {MESH_RANKS} gloo ranks sharing the card (not a multi-GPU "
        "figure): dense sharded step "
        + ", ".join(f"rank {r['rank']} {r['dense_ms']:.3f} ms, peak "
                    f"{r['dense_peak_gib']:.2f} GiB" for r in ranks)
        + f"; ranks' phase {time.perf_counter() - t1:.1f} s")
    log(f"mesh bytes received a rank and a step on {MESH_RANKS} gloo ranks:"
        " the resample's gather " + ", ".join(
            f"threshold {t} {mb:.3f} MB" for t, mb in
            ranks[0]["dense_mb"].items())
        + "; the butterfly " + ", ".join(
            f"{k.split()[0]} islands threshold {k.split()[1]} "
            + "/".join(f"{r['island_mb'][k]:.3f}" for r in ranks) + " MB"
            for k in ranks[0]["island_mb"]) + " (rank 0/1)")
    stats["config5_mesh"][f"{MESH_RANKS} gloo"] = ranks[0]["config5"]
    stats["disp_mesh"][f"{MESH_RANKS} gloo"] = [r["disp"] for r in ranks]
    disp_line = "; ".join(
        f"{k} " + ", ".join(f"{v['mb']:.3f} MB, {v['ms']:.3f} ms"
                            for v in (runs if isinstance(runs, list)
                                      else [runs]))
        for k, runs in stats["disp_mesh"].items())
    log(f"config 5 sharded_run_scan ({CONFIG5['P']} particles, "
        f"{CONFIG5_STEPS} steps) on {gpu}, ms a step and MB received a "
        "rank and a step (predicted): " + "; ".join(
            f"{k}: " + ", ".join(
                f"threshold {t} {v['ms']:.3f} ms, {v['mb']:.3f} MB "
                f"({v['predicted_mb']:.3f}), peak {v['peak_gib']:.2f} GiB"
                for t, v in runs.items())
            for k, runs in stats["config5_mesh"].items())
        + " (rank 0; gloo ranks share the card: not a multi-GPU figure)")
    log(f"dense sharded disparity step on {gpu}, MB received a rank and a "
        f"step and ms a step from step 0 ({MESH_DISP_STEPS} steps; rank 0, "
        "rank 1): " + disp_line + "; after the maps fill, CUDA events: "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in
                    stats["disp_mesh_ms"].items()))
    log(f"phase mesh: ok ({time.perf_counter() - t0:.1f} s)")


# --------------------------------- phase 9e: the measuring entry points --

def finite_positive(values, what):
    bad = {k: v for k, v in values.items()
           if not (np.isfinite(v) and v > 0)}
    if bad:
        raise RuntimeError(f"{what}: not a finite positive time: {bad}")


def phase_bench(dev, stats, gpu):
    """The port's measuring entry points as a user runs them, each with
    every launch count set to 0 just before and read just after: bench.main
    in full (three modes x 5 windows at the dense shape; the pinned CPU
    anchor) and stage_profile.main at both shapes. Then the stage profile
    once more under the timers, every kernel of each stage held against
    plain on that stage's last inputs; and one timed_steps round of each of
    the bench's modes, which holds select (k1 8, 4, 2) and merge (pools
    1088, 832, 704) against plain on the last step's own inputs."""
    from contextlib import ExitStack

    import torch

    from phdslam_tpu_torch import bench, stage_profile
    t0 = time.perf_counter()
    zero_launch_counts()
    rec = bench.main([])
    launches = launch_counts()
    n = len(bench.MODES) * (bench.WARMUP + bench.WINDOWS
                            * (bench.N_STEPS - bench.WARMUP))
    check_launches(launches, dict(select=n, merge=n, preupdate=n), "bench")
    log("bench launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items() if v))
    P = bench.dense_stress_config().n_particles
    if (rec["metric"] != f"ms_per_slam_step_{P}p_cuda"
            or rec["cpu_anchor"] != "pinned"
            or rec["device"] != torch.cuda.get_device_name(0)):
        raise RuntimeError(f"bench line: {rec}")
    finite_positive({k: rec[k] for k in ("value", "ms_fast_merge",
                                         "ms_fast_k2", "vs_baseline")},
                    "bench")
    stats["bench"] = rec
    log(f"phase bench main: ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    zero_launch_counts()
    rec = bench.main(["--quick"])
    launches = launch_counts()
    check_launches(launches, dict(select=n, merge=n, preupdate=n),
                   "bench --quick")
    if (rec["metric"] != "ms_per_slam_step_512p_cuda"
            or rec["device"] != torch.cuda.get_device_name(0)):
        raise RuntimeError(f"bench --quick line: {rec}")
    finite_positive({k: rec[k] for k in ("value", "ms_fast_merge",
                                         "ms_fast_k2", "vs_baseline")},
                    "bench --quick")
    stats["bench_quick"] = rec
    log(f"phase bench --quick: ok ({time.perf_counter() - t0:.1f} s; "
        f"the CPU anchor {rec['cpu_anchor']})")

    t0 = time.perf_counter()
    zero_launch_counts()
    prof = stage_profile.main([])
    launches = launch_counts()
    log("stage profile launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items() if v))
    missing = [k for k in PROFILE_KERNELS if not launches[k]]
    if missing or len(prof["stages"]) != PROFILE_STAGES:
        raise RuntimeError(f"stage profile: kernels never launched "
                           f"{missing}, {len(prof['stages'])} stages")
    finite_positive(prof["stages"], "stage profile")
    stats["stage_profile"] = prof
    log(f"phase stage profile: ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    tm, held = timers(), set()

    def hold(name):
        held.update(agree_on_last_args(tm, stats, f"stage profile {name}"))
        for t in tm.values():
            t.last_args = t.last_out = None

    with ExitStack() as stack:
        for t in tm.values():
            stack.enter_context(t)
        stage_profile.profile_stages(dev, reps=1, log=lambda s: None,
                                     after=hold)
    missing = set(PROFILE_KERNELS) - held
    if missing:
        raise RuntimeError(f"stage profile: never held against plain "
                           f"{sorted(missing)}")
    log(f"phase stage profile against plain: ok "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    shape = f"{DENSE['P']}x{DENSE['F']}x{DENSE['M']}"
    for (name, over), k1 in zip(bench.MODES, (8, 4, 2)):
        pool = DENSE["F"] + DENSE["M"] * (k1 + 1)   # map, detections, births
        _, state, step = stress_stepper(DENSE, WARMUP + TIMED, dev, **over)
        tm = timers()
        _, ms = timed_steps(stats, state, step, WARMUP,
                            f"bench {name} step", shape, tm)
        got = (tm["select"].last_out[1].shape[-1],
               tm["merge"].last_args[0][0].shape[1])
        if got != (k1, pool):
            raise RuntimeError(f"bench {name} step: k1 and merge pool {got},"
                               f" expected {(k1, pool)}")
        log(f"bench {name} step on {gpu}: {ms:.3f} ms, select k1 {k1}, "
            f"merge pool [{DENSE['P']}, {pool}] -> {DENSE['F']}")
    log(f"phase bench modes: ok ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------- phase 9f: the evidence --

# the evidence entry points (phdslam_tpu_torch/evidence/), each run as a
# user runs it at EVIDENCE_SIZE (the JAX scripts' --quick sizes; ignored
# by the entry points without one, which run in full), the CPU reference
# legs cut to their first EVIDENCE_CPU_STEPS steps: (module, arguments,
# the key of its entry in the results file, the JAX record that holds the
# script's keys for it)
EVIDENCE_SIZE = ("--quick",)
EVIDENCE_CPU_STEPS = 3
EVIDENCE_RUNS = (
    ("round3", ("vmap",), "vmap", MC_RECORD),
    ("round3", ("merge",), "merge_modes", MC_RECORD),
    ("round3", ("variants",), "variants", MC_RECORD),
    ("round3", ("parity",), "parity_config2", MC_RECORD),
    ("round3", ("cphd_cpu",), "cphd_cpu_oracle", MC_RECORD),
    ("mixed", (), "mixed", MC_RECORD),
    ("mixed", ("--informed",), "mixed_informed", MC_RECORD),
    ("mixed", ("--labeled", "--set", "keepOobDynamic=1"),
     "mixed_labeled_keepOobDynamic1", MC_RECORD),
    ("disparity", (), "disparity", MC_RECORD),
    ("disparity", ("--oracle",), "disparity_cpu_oracle", MC_RECORD),
    ("fastslam", ("--cell", "2.0", "0.25", "2"), "c2_s0.25_f2",
     "results/fastslam_grid.json"),
    ("fastslam", ("--cell", "2.0", "0.25", "0"), "c2_s0.25_f0",
     "results/fastslam_grid.json"),
    ("cphd_dwell", (), "cphd_dwell", "results/cphd_dwell.json"),
    ("ospa_latency", (), "ospa_latency", "results/ospa_latency.json"),
)
# the pose bars of PERF.md section 2 on each entry's pose numbers (the
# other arms logged beside JAX's: particle weighting 1 and 2 and the
# convolution CPHD track worse in JAX too), the CPHD dwell criterion of
# BASELINE.md config 3, and the OSPA gap
EVIDENCE_BARS = {
    "vmap": dict(pose_late_mean_vmapped=POSE_BAR_M,
                 pose_late_mean_sequential=POSE_BAR_M),
    "merge_modes": {f"{arm}.pose_late_mean": POSE_BAR_M for arm in (
        "exact_merge", "fast_merge", "fast_merge_k2")},
    "variants": {"PHD.pose_late_mean": POSE_BAR_M,
                 "CPHD.pose_late_mean": POSE_BAR_M},
    "parity_config2": dict(tpu_pose_late_mean=POSE_BAR_M),
    "cphd_cpu_oracle": dict(tpu_pose_mean=POSE_BAR_M),
    "mixed": dict(pose_mean=MIXED_POSE_BAR_M),
    "mixed_informed": dict(pose_mean=MIXED_POSE_BAR_M),
    "mixed_labeled_keepOobDynamic1": dict(pose_mean=MIXED_POSE_BAR_M),
    "disparity": dict(pose_mean=DISP_POSE_BAR_M),
    "disparity_cpu_oracle": dict(tpu_pose_mean=DISP_POSE_BAR_M),
    "c2_s0.25_f2": dict(pose_mean=FS_SEED_BAR_M),
    "c2_s0.25_f0": dict(pose_mean=FS_SEED_BAR_M),
    "cphd_dwell": dict(dwell_err_mean=2.0),
    "ospa_latency": {f"rows.{i}.max_gap": OSPA_TOL for i in range(3)},
}


def step_kernels(cfg):
    """The kernels one update step of cfg launches, once each."""
    if cfg.selectByIndex:
        raise ValueError("the evidence runs no select_by_index arm")
    if cfg.filterType == 2:
        return ("auction", "preupdate")
    if cfg.featureModel == 2:
        return ("select", "select4", "merge", "merge4", "preupdate")
    if cfg.filterType == 1:
        return ("select", "merge", "esf", "preupdate")
    return ("select", "merge", "preupdate")


class UpdateCounter:
    """The launches an entry point should make, counted at the filters'
    own gates: every slam_step with a measurement in some run launches its
    filter's kernels once, every disparity_step with a measurement merge3
    once, every ospa_torch call the square auction once."""

    def __init__(self):
        from phdslam_tpu_torch.filter import disparity, step
        from phdslam_tpu_torch.ops import ospa
        self.counts = dict.fromkeys(launch_counts(), 0)
        self.patches = [(step, "slam_step", self._slam),
                        (disparity, "disparity_step", self._disparity),
                        (ospa, "ospa_torch", self._ospa)]
        self.orig = {}

    def _wrap(self, module, name, count):
        orig = getattr(module, name)

        def counted(*a, **kw):
            for k in count(*a, **kw):
                self.counts[k] += 1
            return orig(*a, **kw)
        return counted

    def _slam(self, state, control, z, dt, do_predict, cfg, **kw):
        return step_kernels(cfg) if z.any_run else ()

    def _disparity(self, state, z, *a, **kw):
        return ("merge3",) if z.count > 0 else ()

    def _ospa(self, *a, **kw):
        return ("ospa_auction",)

    def __enter__(self):
        for module, name, count in self.patches:
            self.orig[(module, name)] = getattr(module, name)
            setattr(module, name, self._wrap(module, name, count))
        return self

    def __exit__(self, *exc):
        for (module, name), fn in self.orig.items():
            setattr(module, name, fn)


def json_leaves(obj, prefix=""):
    """(dotted path, value) of every leaf of a JSON value."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from json_leaves(v, f"{prefix}{k}.")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from json_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], obj


def missing_keys(record, entry, prefix=""):
    """The keys of the JAX record (nested dicts) the port's entry lacks."""
    out = []
    for k, v in record.items():
        if k not in entry:
            out.append(prefix + k)
        elif isinstance(v, dict) and isinstance(entry[k], dict):
            out += missing_keys(v, entry[k], f"{prefix}{k}.")
    return out


def check_entry(key, entry, record, what):
    """The entry has every key of the JAX script's record, every number in
    it is finite, and its pose numbers meet EVIDENCE_BARS; returns the
    bars' (value, bar, JAX's value) for the log."""
    gone = missing_keys(record, entry)
    if gone:
        raise RuntimeError(f"{what}: keys of the JAX script missing {gone}")
    leaves = dict(json_leaves(entry))
    bad = [p for p, v in leaves.items() if isinstance(v, float)
           and not np.isfinite(v)]
    if bad:
        raise RuntimeError(f"{what}: values not finite {bad}")
    jax_leaves = dict(json_leaves(record))
    held = {}
    for path, bar in EVIDENCE_BARS[key].items():
        v = leaves[path]
        held[path] = (v, bar, jax_leaves.get(path))
        if not (v is not None and v <= bar):
            raise RuntimeError(f"{what}: {path} = {v}, not within {bar}")
    return held, sum(v is None for v in leaves.values())


def phase_evidence(dev, stats, d):
    """Every evidence entry point as a user runs it (main(argv) with
    --device cuda, EVIDENCE_SIZE, the CPU legs cut to EVIDENCE_CPU_STEPS
    steps), the results into a temporary file, each with every launch
    count set to 0 just before: each kernel launched once per update step
    the entry's filters took (check_launches on UpdateCounter's counts),
    every kernel it launched held against plain on its last inputs, the
    entry with every key of the JAX record, finite, within its bars."""
    import importlib
    from contextlib import ExitStack
    t0 = time.perf_counter()
    out = str(Path(d, "port_evidence.json"))
    records = {}
    for name, args, key, record_file in EVIDENCE_RUNS:
        t_run = time.perf_counter()
        mod = importlib.import_module(f"phdslam_tpu_torch.evidence.{name}")
        argv = [*args, *EVIDENCE_SIZE, "--device", dev.type, "--out", out]
        if name in ("round3", "disparity", "mixed"):
            argv += ["--cpu-steps", str(EVIDENCE_CPU_STEPS)]
        what = f"evidence {name} {' '.join(args)}".rstrip()
        tm = timers()
        with ExitStack() as stack, UpdateCounter() as expect:
            for t in tm.values():
                stack.enter_context(t)
            zero_launch_counts()
            res = mod.main(argv)
            launches = launch_counts()
        check_launches(launches, expect.counts, what)
        held = agree_on_last_args(tm, stats, what)
        if record_file not in records:
            records[record_file] = json.loads((ROOT / record_file)
                                              .read_text())
        rec = records[record_file]        # a file of entries, or the entry
        bars, n_none = check_entry(key, res[key], rec.get(key, rec), what)
        log(f"{what}: launches " + ", ".join(
            f"{k} {v}" for k, v in launches.items() if v)
            + f" (update steps counted at the filters' gates); held against"
            f" plain {sorted(held)}; bars " + "; ".join(
                f"{p} {v:.4g} (bar {b}, JAX {j})" for p, (v, b, j)
                in bars.items()) + f"; {n_none} null values; "
            f"{time.perf_counter() - t_run:.1f} s")
    log(f"the CPU reference legs cut to {EVIDENCE_CPU_STEPS} steps "
        f"(round3 parity and cphd_cpu, disparity --oracle, mixed)")
    log(f"phase evidence: ok ({time.perf_counter() - t0:.1f} s)")



# ------------------------------------- phase 9g: BASELINE config 5 --

def config5_cfg(run_dir, **over):
    """BASELINE config 5: run_dir's run.cfg (cfg/ackerman_synth.cfg with
    phase 3's start pose) at CONFIG5's width, then the overrides."""
    from phdslam_tpu_torch import load_config
    return load_config(str(Path(run_dir, "run.cfg"))).replace(
        n_particles=CONFIG5["P"], maxFeatures=CONFIG5["F"],
        maxMeasurements=CONFIG5["M"], **over)


def config5_kernels(tm, what):
    """select and merge at config 5's shape on the step's own last
    inputs (tm: the timers of a config-5 pass): select against its plain
    version chunk by chunk (CONFIG5_CHUNK particles), merge against
    merge_plain on the step's real pool, two merge launches bit-identical;
    each timed (CUDA events) beside its bound, counted as PERF.md section
    6 counts it. Returns {kernel: dict(ms, bound_ms, bound_by, max_abs_err,
    shape)}."""
    import torch
    S, G = _mods()[0], _mods()[2]
    out = {}
    t = tm["select"]
    (chans, z, nv), kw = t.last_args
    P, F = chans[0].shape
    M = z.shape[-2]
    check = compare_rows if kw.get("by_index") else select_outputs_agree
    _, n_bad, err = chunked(
        lambda c: t.orig(c, z, nv, **kw),
        lambda c: S.select_plain(c, z, nv, **kw), check,
        lambda lo, hi: [c[lo:hi] for c in chans], P, chunk=CONFIG5_CHUNK)
    _limit(n_bad, P, f"select ({what})")
    k1 = kw["k1"]
    b_ms, by = bound_ms(select_bytes(P, F, M, k1, kw.get("by_index", False)),
                        P * M * F * (SELECT_TRIPLE_OPS + k1
                                     + (0 if kw["raw"] else 2)))
    out["select"] = dict(
        ms=cuda_ms(lambda: t.orig(chans, z, nv, **kw), 10), bound_ms=b_ms,
        bound_by=by, max_abs_err=err, differing=n_bad,
        shape=f"[{P}, {M}, {F}] k1 {k1}")
    t = tm["merge"]
    a, kw = t.last_args
    pool, (sep, cap, metric) = list(a[:6]), a[6:9]
    K = pool[0].shape[1]
    kern = t.orig(*a, **kw)
    n_bad, err = compare_rows(kern, G.merge_plain(*a, **kw))
    _limit(n_bad, P, f"merge ({what})")
    bit_identical(lambda: t.orig(*a, **kw),
                  f"merge [{P}, {K}] -> {cap} ({what})")
    tests = merge_tests(pool, sep, cap, metric)
    counts = torch.zeros((P, len(G.STATS)), dtype=torch.int32,
                         device=pool[0].device)
    t.orig(*pool, sep, cap, metric, stats=counts)
    b_ms, by = bound_ms(4 * 6 * P * (K + cap), merge_ops(counts))
    out["merge"] = dict(
        ms=cuda_ms(lambda: t.orig(*a, **kw), 5), bound_ms=b_ms,
        bound_by=by, max_abs_err=err, differing=n_bad,
        shape=f"[{P}, {K}] -> {cap}", tests=tests)
    log(f"{what}, the kernels on the step's last inputs: " + "; ".join(
        f"{k} {v['shape']} particles differing {v['differing']}/{P} "
        f"(max_abs_err {v['max_abs_err']:.3e}), {v['ms']:.4f} ms, bound "
        f"{v['bound_ms']:.4f} ms by {v['bound_by']}" for k, v in out.items())
        + f" ({out['merge']['tests']} merge candidate tests)")
    return out


def phase_config5(dev, stats, gpu):
    """9g: BASELINE config 5, one filter of CONFIG5['P'] particles on this
    card (eval_baselines.py's config 5 on the port): run_scan over the
    first CONFIG5_STEPS steps of phase 3's run, a warm pass and then a
    timed pass ending in a synchronise, at the exact merge and at
    merge_mode 1 (ms a step, host clock, with the split by CUDA events;
    peak device memory), launch counts from 0 before the timed pass
    (select and merge once a step); select and merge on each pass's last
    inputs (config5_kernels); then the runner in scan mode at the same
    width over the whole 330-step run: the log contract, select and merge
    once a step, mean pose error below POSE_BAR_M, peak memory."""
    from contextlib import ExitStack

    import torch
    from phdslam_tpu_torch.filter.state import SlamState
    from phdslam_tpu_torch.filter.step import run_scan
    t0 = time.perf_counter()
    P = CONFIG5["P"]
    shape = "x".join(str(CONFIG5[k]) for k in "PFM")
    cfg_text = (ROOT / "cfg/ackerman_synth.cfg").read_text()
    res = dict(timing={})
    with tempfile.TemporaryDirectory() as d:
        sc, n_steps, start = static_run_files(d)
        Path(d, "run.cfg").write_text(cfg_text + start)
        base = config5_cfg(d)
        ctrls, zs, dts = scan_inputs(d, base, dev, CONFIG5_STEPS)
        state_mb = sum(t.numel() * t.element_size() for t in tree_tensors(
            SlamState.create(base, dev)).values()) / 1e6
        for mode, over in (("exact", {}), ("merge_mode 1",
                                           dict(mergeMode=1))):
            cfg = base.replace(**over)
            what = f"config 5 run_scan {shape}, {mode}"

            def run():
                gen = torch.Generator(device=dev).manual_seed(0)
                return run_scan(SlamState.create(cfg, dev), ctrls, zs, dts,
                                cfg, generator=gen)

            reset_peak_memory()
            run()
            torch.cuda.synchronize()
            tm = timers()
            zero_launch_counts()
            with ExitStack() as stack:
                for tmr in tm.values():
                    stack.enter_context(tmr)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                _, aux = run()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t1) * 1e3 / CONFIG5_STEPS
            launches = launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            check_launches(launches, dict(select=CONFIG5_STEPS,
                                          merge=CONFIG5_STEPS, esf=0,
                                          auction=0,
                                          preupdate=CONFIG5_STEPS), what)
            k_ms = {k: t.ms() / CONFIG5_STEPS for k, t in tm.items()
                    if t.pairs}
            neff = aux.neff.cpu().numpy()
            pose = aux.expected_pose.cpu().numpy()
            if not (np.isfinite(neff).all() and np.isfinite(pose).all()):
                raise RuntimeError(f"{what}: a neff or pose is not finite")
            log(f"{what} on {gpu}: {CONFIG5_STEPS} steps, {ms:.3f} ms/step "
                f"(host clock, timed pass after a warm pass) = glue "
                f"{ms - sum(k_ms.values()):.3f} + " + " + ".join(
                    f"{k} {v:.3f}" for k, v in k_ms.items())
                + f" (CUDA events); peak device memory {peak:.2f} GiB (the "
                f"state {state_mb:.1f} MB); resampled on "
                f"{int(aux.resampled.sum())} steps, last neff "
                f"{float(neff[-1]):.4f}; launches select "
                f"{launches['select']} merge {launches['merge']}")
            res["timing"][mode] = dict(
                ms=ms, peak_gib=peak, kernels=config5_kernels(tm, what),
                kernel_ms=k_ms)

        # the runner in scan mode over the whole run at this width
        reset_peak_memory()
        launches, run_s, out = run_runner(
            d, cfg_text, start + f"n_particles = {P}\n", dev, {},
            mode="scan")
        peak = torch.cuda.max_memory_allocated() / 2**30
        names = sorted(p.name for p in out.glob("state_estimate*.log"))
        poses = []
        for name in names:
            with open(out / name) as f:
                poses.append([float(v) for v in f.readline().split()])
        errs = np.linalg.norm(np.array(poses)[:, :2]
                              - sc.traj[:len(poses), :2], axis=1)
        loop_ms = np.loadtxt(out / "loopTime.log")
        rows = metrics_rows(out)
        with open(out / names[-1]) as f:
            lines = f.read().splitlines()
        n_w, n_p = len(lines[3].split()), len(lines[4].split())
    what = f"config 5 runner --mode scan {shape}"
    log(f"{what}: {len(names)} state_estimate logs ({n_w} weights, {n_p} "
        f"pose values in the last), {len(loop_ms)} loop times, {len(rows)} "
        f"metrics lines; pose error mean {errs.mean():.3f} m max "
        f"{errs.max():.3f} m; {loop_ms.mean():.3f} ms/step (the scan); "
        f"launches select {launches['select']} merge {launches['merge']}; "
        f"peak device memory {peak:.2f} GiB; run {run_s:.1f} s (logs "
        "included)")
    if names != [f"state_estimate{t:05d}.log" for t in range(n_steps)] \
            or len(loop_ms) != n_steps or len(rows) != n_steps \
            or n_w != P or n_p != 6 * P or len(lines) != 7:
        raise RuntimeError(f"{what}: log contract incomplete")
    check_launches(launches, dict(select=n_steps, merge=n_steps, esf=0,
                                  auction=0, preupdate=n_steps), what)
    if not np.isfinite(errs).all() or errs.mean() >= POSE_BAR_M:
        raise RuntimeError(f"{what}: mean pose error {errs.mean():.3f} m "
                           f"is not below {POSE_BAR_M} m")
    res["runner"] = dict(ms=float(loop_ms.mean()), pose_err=float(
        errs.mean()), peak_gib=peak, run_s=run_s)
    stats["config5"] = res
    log(f"phase config 5: ok ({time.perf_counter() - t0:.1f} s)")


def config5_mesh_scans(dev, mesh, run_dir):
    """BASELINE config 5 over the mesh: sharded_run_scan at CONFIG5's width
    over the first CONFIG5_STEPS steps of phase 3's run (run_dir's files)
    at MESH_THRESHOLDS (never, always resampling), a warm pass and then a
    timed pass (host clock, ending in a synchronise; launch counts and the
    traffic record from 0), each against run_scan in one process on the
    same draws, bit for bit: select and merge once a step, one read_flag a
    step, the state's leaves gathered on firing steps only, the bytes this
    rank received a step within CONFIG5_BYTES_TOL of (W - 1) / W x (32 B a
    particle: the weights twice, the pose; and the state's bytes on a
    firing step). Returns {threshold: dict(ms, mb, predicted_mb, peak_gib,
    fired)}."""
    import torch
    from phdslam_tpu_torch.filter.state import SlamState
    from phdslam_tpu_torch.filter.step import run_scan
    from phdslam_tpu_torch.parallel.mesh import (shard_state,
                                                 sharded_run_scan,
                                                 unshard_state)
    W, P = mesh.world_size, CONFIG5["P"]
    base = config5_cfg(run_dir)
    ctrls, zs, dts = scan_inputs(run_dir, base, dev, CONFIG5_STEPS)
    leaves = tree_tensors(SlamState.create(base.replace(n_particles=1),
                                           dev))
    state_bytes = P * sum(t.numel() * t.element_size()
                          for t in leaves.values())
    out = {}
    for thresh in MESH_THRESHOLDS:
        cfg = base.replace(resampleThresh=thresh)
        what = (f"config 5 sharded_run_scan ({W} {mesh.backend} ranks x "
                f"{P // W}, threshold {thresh})")

        def run(m):
            gen = torch.Generator(device=dev).manual_seed(0)
            if m is None:
                return run_scan(SlamState.create(cfg, dev), ctrls, zs, dts,
                                cfg, generator=gen)
            return sharded_run_scan(cfg, m)(
                shard_state(SlamState.create(cfg, dev), m), ctrls, zs, dts,
                generator=gen)

        run(mesh)
        torch.cuda.synchronize()
        reset_peak_memory()
        zero_launch_counts()
        mesh.take_traffic()
        t1 = time.perf_counter()
        state, auxs = run(mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3 / CONFIG5_STEPS
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches, moved = launch_counts(), mesh.take_traffic()
        state = unshard_state(state, mesh)
        p_state, p_auxs = run(None)
        same_bits((p_auxs, p_state), (auxs, state), what)
        check_launches(launches, dict(select=CONFIG5_STEPS,
                                      merge=CONFIG5_STEPS,
                                      preupdate=CONFIG5_STEPS), what)
        fired = int(auxs.resampled.sum())
        if fired != (CONFIG5_STEPS if thresh > 1.0 else 0):
            raise RuntimeError(f"{what}: the resample fired on {fired} of "
                               f"{CONFIG5_STEPS} steps")
        check_moved(moved, CONFIG5_STEPS, what, "read_flag resample",
                    "gather_rows resample",
                    len(leaves) if thresh > 1.0 else 0, P // W * 6 * 4)
        mb = sum(v["received"] for v in moved.values()) / CONFIG5_STEPS / 1e6
        pred = (W - 1) / W * (P * 32 + (state_bytes if thresh > 1.0
                                        else 0)) / 1e6
        log(f"{what}: {CONFIG5_STEPS} steps bit for bit with run_scan in one "
            f"process (every aux value and the final state), launches "
            f"select {launches['select']} merge {launches['merge']}, "
            f"resampled on {fired} steps; {ms:.3f} ms a step (host clock, "
            f"after a warm pass), peak {peak:.2f} GiB; received "
            f"{mb:.6f} MB a step (predicted {pred:.6f}); a step: "
            + traffic_line(moved, CONFIG5_STEPS))
        if abs(mb - pred) > CONFIG5_BYTES_TOL * pred:
            raise RuntimeError(f"{what}: {mb:.6f} MB received a step, not "
                               f"within {CONFIG5_BYTES_TOL:.0%} of the "
                               f"predicted {pred:.6f} MB")
        out[thresh] = dict(ms=ms, mb=mb, predicted_mb=pred, peak_gib=peak,
                           fired=fired)
    return out


def mesh_dense_disparity(dev, mesh):
    """The dense disparity step (phase 9's 8192 x 128 x 64 points x 48)
    through sharded_disparity_step, MESH_DISP_STEPS steps from step 0,
    against disparity_step in one process (mesh_pair, bit for bit): no
    read of the device; the weights and poses gathered (label step, 2
    calls a step); the pose, weights and clouds gathered on every step,
    fired or not (label resample, 5 calls a step, one rank's shard each),
    as JAX's ungated jnp.take. Returns dict(mb: received a step by this
    rank, ms: a sharded step, host clock, from step 0)."""
    from phdslam_tpu_torch import load_config
    W, P, F = mesh.world_size, DENSE_DISP["P"], DENSE_DISP["F"]
    n = MESH_DISP_STEPS
    npp = load_config(str(ROOT / "cfg/disparity_synth.cfg")) \
        .particlesPerFeature
    what = (f"dense sharded disparity step ({W} {mesh.backend} ranks x "
            f"{P // W})")
    _, moved, ms = mesh_pair(
        lambda m: disparity_stepper(DENSE_DISP, n, dev, mesh=m), n, mesh,
        what)
    per = P // W
    shard = per * (12 + F + 3 * F * npp) * 4
    expect = {"gather_rows step": (2 * n, n * per * 13 * 4),
              "gather_rows resample": (5 * n, n * shard)}
    got = {k: (v["calls"], v["offered"]) for k, v in moved.items()}
    received = {k: v["received"] for k, v in moved.items()}
    if got != expect or any(received[k] != expect[k][1] * (W - 1)
                            for k in expect):
        raise RuntimeError(f"{what}: traffic {moved}, expected (calls, "
                           f"offered) {expect}")
    return dict(mb=sum(received.values()) / n / 1e6, ms=ms)


# ------------------------------------- phase 9h: constant-velocity motion --

def phase_cv_motion(dev, stats, gpu):
    """9h: the constant-velocity motion model (motion_type 0,
    cfg/cv_synth.cfg, BASELINE config 1's) at the shipped width (256 x 128
    x 64) on phase 3's measurement sets: CV_STEPS steps on the card from
    the start pose fill the map; then one step from that state with one
    set of draws, on the card (kernels) and on the CPU (plain versions):
    the poses, log-weights and maps within rtol/atol (map means and
    covariances where a slot is live), the resample indices exactly, at
    most MAX_DIFFER of the particles differing, the aux values within
    rtol/atol; select and merge launched once a card step. Then the dense
    CV step (the stress stream at 8192 x 512 x 64) timed beside phase 7's
    Ackerman step, ISLAND_ROUNDS rounds of (Ackerman, CV)."""
    import torch
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.filter.state import SlamState
    from phdslam_tpu_torch.filter.step import draw_noise, slam_step
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        _, _, start = static_run_files(d)
        Path(d, "run.cfg").write_text(
            (ROOT / "cfg/cv_synth.cfg").read_text() + start
            + f"n_particles = {SHIPPED['P']}\n")
        cfg = load_config(str(Path(d, "run.cfg")))
        ctrls, zs, dts = scan_inputs(d, cfg, dev, CV_STEPS + 1)
    P = cfg.n_particles
    what = (f"CV motion step {P}x{cfg.maxFeatures}x{cfg.maxMeasurements} "
            f"(cfg/cv_synth.cfg)")
    gen = torch.Generator(device=dev).manual_seed(0)
    state = SlamState.create(cfg, dev)
    zero_launch_counts()
    for t in range(CV_STEPS):
        state, _ = slam_step(state, ctrls[t], zs[t], dts[t], t > 0, cfg,
                             generator=gen,
                             z_prev=zs[t - 1] if t else None)
    t = CV_STEPS
    noise = draw_noise(cfg, P, dev, gen, state.log_weights.dtype)
    card, aux = slam_step(state, ctrls[t], zs[t], dts[t], True, cfg,
                          noise=noise, z_prev=zs[t - 1])
    launches = launch_counts()
    cpu = torch.device("cpu")
    plain, p_aux = slam_step(state.map(lambda x: x.cpu()), ctrls[t],
                             zs[t].to(cpu), dts[t], True, cfg,
                             noise=tuple(x.cpu() for x in noise),
                             z_prev=zs[t - 1].to(cpu))
    check_launches(launches, dict(select=CV_STEPS + 1, merge=CV_STEPS + 1,
                                  esf=0, auction=0, preupdate=CV_STEPS + 1),
                   what)
    ms_, mp_ = card.map_static, plain.map_static
    live = (ms_.w.cpu() > 0) | (mp_.w > 0)
    kern = [card.pose.cpu(), card.log_weights.cpu(),
            card.resample_idx.cpu(), ms_.w.cpu()] + [
        getattr(ms_, c).cpu() for c in ("mx", "my", "c00", "c01", "c11")]
    ref = [plain.pose, plain.log_weights, plain.resample_idx, mp_.w] + [
        getattr(mp_, c) for c in ("mx", "my", "c00", "c01", "c11")]
    n_bad, err = compare_rows(kern, ref, [None] * 4 + [live] * 5)
    aux_bad = [k for k in ("expected_pose", "neff", "log_lik")
               if not torch.allclose(getattr(aux, k).cpu(),
                                     getattr(p_aux, k), rtol=RTOL,
                                     atol=ATOL)]
    moved = float((card.pose.cpu() - state.pose.cpu()).norm(dim=1).mean())
    log(f"{what}, step {t} from the state after {CV_STEPS} card steps, one "
        f"set of draws: card (kernels) against the CPU (plain versions): "
        f"particles differing {n_bad}/{P} (max_abs_err {err:.3e}), aux "
        f"values differing {aux_bad}, resampled "
        f"{bool(aux.resampled)}/{bool(p_aux.resampled)}, live slots "
        f"{int((ms_.w > 0).sum(1).max())} max, mean pose move "
        f"{moved:.4f} m; launches select {launches['select']} merge "
        f"{launches['merge']}")
    _limit(n_bad, P, what)
    if aux_bad or bool(aux.resampled) != bool(p_aux.resampled):
        raise RuntimeError(f"{what}: aux values {aux_bad} differ")
    stats["cv_max_abs_err"] = err

    shape = f"{DENSE['P']}x{DENSE['F']}x{DENSE['M']}"
    ms = {"Ackerman": [], "CV": []}
    for _ in range(ISLAND_ROUNDS):
        for name, cfg_file in (("Ackerman", "cfg/ackerman_synth.cfg"),
                               ("CV", "cfg/cv_synth.cfg")):
            _, st, step = stress_stepper(DENSE, WARMUP + TIMED, dev,
                                         cfg_file=cfg_file)
            ms[name].append(timed_steps(stats, st, step, WARMUP,
                                        f"dense {name} step", shape)[1])
    log(f"dense timing on {gpu}, rounds of (Ackerman, CV): " + "; ".join(
        f"{k} " + ", ".join(f"{x:.3f}" for x in v) + " ms"
        for k, v in ms.items()))
    stats["cv_dense_ms"] = ms
    log(f"phase CV motion: ok ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------- optional: --profile --

def phase_profile(dev):
    """torch.profiler over PROFILED steps, after PROFILE_WARMUP steps, of
    the static step at the dense and the shipped shape (stress stream), the
    dense CPHD step and the dense disparity step (phase 9's shapes), and
    the FastSLAM step at the dense and the shipped shape.
    Prints the host wall time per step (without the profiler), the device's
    busy share of the profiled window (the union of its kernel and copy
    intervals) and the ops and kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    n = PROFILE_WARMUP + 2 * PROFILED
    cases = (
        ("dense", DENSE, lambda: stress_stepper(DENSE, n, dev)[1:]),
        ("shipped", SHIPPED,
         lambda: stress_stepper(SHIPPED, n, dev, False)[1:]),
        ("dense CPHD", DENSE_CPHD, lambda: stress_stepper(
            DENSE_CPHD, n, dev, filterType=1, maxCardinality=127,
            gateBirths=True, gateThreshold=9.0)[1:]),
        ("dense disparity", DENSE_DISP,
         lambda: disparity_stepper(DENSE_DISP, n, dev)),
        ("dense FastSLAM", DENSE_FS, lambda: stress_stepper(
            DENSE_FS, n, dev, cfg_file="cfg/fastslam_synth.cfg")[1:]),
        ("shipped FastSLAM", SHIPPED, lambda: stress_stepper(
            SHIPPED, n, dev, False, cfg_file="cfg/fastslam_synth.cfg")[1:]))
    for name, shape, make in cases:
        state, step = make()
        for t in range(PROFILE_WARMUP):
            state, _ = step(state, t)
        torch.cuda.synchronize()
        t_wall = time.perf_counter()
        for t in range(PROFILE_WARMUP, PROFILE_WARMUP + PROFILED):
            state, _ = step(state, t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_wall) * 1e3 / PROFILED
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for t in range(PROFILE_WARMUP + PROFILED, n):
                state, _ = step(state, t)
            torch.cuda.synchronize()
        busy, window, n_act = device_busy(prof)
        dims = "x".join(str(shape[k]) for k in "PFM")
        busy_ms = busy / 1e3 / PROFILED
        # the profiler slows the host, so the window overstates the idle
        # share; the device's work is the same with it off
        log(f"profile {name} {dims}: host wall {wall_ms:.3f} ms/step "
            f"(profiler off); device busy {busy_ms:.3f} ms/step = "
            f"{busy_ms / wall_ms:.1%} of that wall, {busy / window:.1%} "
            f"of the profiled window ({window / 1e3 / PROFILED:.3f} "
            f"ms/step); {n_act / PROFILED:.0f} device activities/step")
        log_top_ops(prof)
    log(f"phase profile: ok ({time.perf_counter() - t0:.1f} s)")


def log_top_ops(prof):
    """The PROFILE_ROWS ops that launch device work, and our kernels
    (launched outside any op), with the most device time per step."""
    from torch.autograd import DeviceType
    rows = [e for e in prof.key_averages() if e.self_device_time_total
            > 0 and (e.device_type == DeviceType.CPU
                     or "_kernel" in e.key and "at::" not in e.key)]
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:PROFILE_ROWS]:
        log(f"  {e.self_device_time_total / 1e3 / PROFILED:8.3f} ms/step"
            f"  {e.count / PROFILED:5.1f} calls/step  {e.key[:70]}")


# ------------------------------------------------------------------ main --

def main(argv=None):
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the static and FastSLAM steps "
                    "(dense and shipped shape) and the dense CPHD and "
                    "disparity steps with torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "phdslam_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no phdslam_tpu_torch package beside {__file__};"
              " run it from a checkout of the repository", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from phdslam_tpu_torch.bench import gpu_line
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gpu = gpu_line()
    log(gpu)                        # nvidia-smi's name, power.limit as is
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    from phdslam_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _, info = _build.library()
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"phase build: ok ({time.perf_counter() - t0:.1f} s, nvcc "
        f"{info['seconds']:.1f} s, {'built' if info['built'] else 'cached'}"
        f" {info['path']})")

    stats = {}
    phase_preupdate(dev, stats)
    phase_select(dev, stats)
    phase_merge(dev, stats)
    phase_select4(dev, stats)
    phase_select_runs(dev, stats)
    phase_merge4(dev, stats)
    phase_merge3(dev, stats)
    phase_esf(dev, stats)
    phase_auction(dev, stats)
    phase_ospa(dev, stats)
    phase_wide(dev, stats)
    phase_main_path(dev, stats)
    phase_resume(dev, stats)
    phase_mixed_main_path(dev, stats)
    phase_disparity_main_path(dev, stats)
    phase_cphd_main_path(dev, stats)
    phase_seed_envelopes(dev, stats)
    phase_mc_envelope(dev, stats)
    phase_mc_one_step(dev, stats)
    phase_sync_free_batch(dev, stats)
    phase_mc_fastslam_mixed(dev, stats)
    phase_mc_fill(dev, stats, args.profile)
    phase_fastslam_main_path(dev, stats)
    phase_fastslam_runner(dev, stats)
    phase_dense(dev, stats, gpu)
    phase_dense_cphd_disparity(dev, stats, gpu)
    phase_dense_fastslam(dev, stats, gpu)
    phase_cv_motion(dev, stats, gpu)
    phase_islands(dev, stats, gpu)
    with tempfile.TemporaryDirectory() as d:
        phase_island_runner(dev, stats, d)
        phase_mesh(dev, stats, gpu, d)
    phase_bench(dev, stats, gpu)
    with tempfile.TemporaryDirectory() as d:
        phase_evidence(dev, stats, d)
    phase_config5(dev, stats, gpu)
    if args.profile:
        phase_profile(dev)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")

    kernels = []
    for name, src, replaces in KERNELS:
        s = stats[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=s["launches"], max_abs_err=s["max_abs_err"],
            ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"]))
    log(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

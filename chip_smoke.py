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
     - select and select by index: the shipped (256 x 128 x 64) and dense
       (8192 x 512 x 64) shapes, normalised, raw and n_valid < M; the
       by-index kernel picks what the payload kernel picks, and the gather
       at its indices reproduces the payload
     - merge: the dense pool ([8192, 1088] -> 512, metrics 0 and 1), the
       shipped pool ([256, 704] -> 128), an odd P and an odd cap
     - select4 and select4 by index: the shipped mixed (256 x 128 x 64),
       dense (8192 x 512 x 64) and odd-P (1001) shapes, k1 = 8, with the
       same by-index checks
     - merge4: [256, 704] -> 128 at min_sep 1.0, [8192, 1088] -> 512 at
       1.0 and 5.0, an odd P (1001) and an odd cap (77)
     - merge3: the shipped disparity pool ([64, 496] -> 64), an odd P
       ([1001, 496] -> 64) and the dense pool ([8192, 560] -> 128), each
       timed beside its bound, min_sep 4
     - esf: [1024, 64], [256, 64], [1001, 48] with 9 trailing -inf slots,
       [7, 1] and [64, 256], each timed beside its bound; finite entries
       compared, the -1e30 sentinel in the same places
     Values are held to rtol 2e-4 / atol 1e-5 (payload only where w > 0;
     indices exactly); a particle whose outputs miss that (a near-tie
     picked in another order) is counted, and a check fails above 0.1 % of
     the particles.
  3. static main path - the runner (loop mode, --device cuda) over a
     330-step simdata run at cfg/ackerman_synth.cfg: the log contract,
     select and merge launched once per update step, mean pose error below
     1.5 m, both kernels against their plain versions on the run's last
     launch
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
     three kernels against plain on their last launches
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
 10. the card's name and power limit, the kernels' JSON line, then
     {"ok": true, "device": {...}} last

    python3 chip_smoke.py --profile

adds, before the JSON lines, a torch.profiler pass over the static step at
the dense and the shipped shape, the dense CPHD step and the dense
disparity step: host wall time, the device's busy share and the ops with
the most device time (the breakdown in PERF.md).
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
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
MERGE3_CASES = [                    # (P, K, cap, min_separation)
    (8192, 560, 128, 4.0),          # dense: 128 + 48 x 8 + 48 candidates
    (64, 496, 64, 4.0),             # the shipped disparity pool
    (1001, 496, 64, 4.0),           # odd P
]
ESF_CASES = [                       # (P, M, trailing -inf slots)
    (1024, 64, 0),                  # the dense CPHD shape
    (256, 64, 0),                   # the shipped CPHD shape
    (1001, 48, 9),
    (7, 1, 0),
    (64, 256, 0),
]
RUN_STEPS = 330
POSE_BAR_M = 1.5
MIXED_LANDMARKS, MIXED_STEPS = 40, 150
# scripts/mixed_evidence.py's movers: initial positions and velocities
MOVER0 = np.array([[13.0, 9.0], [-9.0, 12.0], [10.0, -6.0]])
MOVER_V = np.array([[-0.22, -0.10], [0.20, -0.12], [-0.14, 0.18]])
MIXED_POSE_BAR_M = 2.0
MOVER_SHARE = 0.5                   # settled mover steps confirmed, at least
BY_INDEX_STEPS = 40
DISP_POSE_BAR_M = 1.5
DENSE_CPHD = dict(P=1024, F=128, M=64)
DENSE_DISP = dict(P=8192, F=128, M=48)
DISP_WARMUP = 8                     # fills the dense disparity map first
WARMUP, TIMED = 3, 16
PROFILE_WARMUP, PROFILED, PROFILE_ROWS = 8, 4, 12
# NVIDIA H100 SXM data sheet, at a 700 W power limit: float32 outside the
# tensor cores and HBM3 bandwidth
PEAK_F32_OPS, PEAK_BYTES = 67e12, 3.35e12
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
# 3-D: the averaged covariance (12), determinant and adjugate (27), the
# quadratic form (15), the divide and the compares
MERGE3_TEST_OPS = 60
# one logaddexp of the ESF build-up: the add of ll_j, max, min, sub, exp,
# log1p, add; the exp and log1p counted as one operation each (the special
# function units run them at a quarter of this rate: an optimistic bound)
LAE_OPS = 7
KERNELS = (                         # name, source, the TPU kernel replaced
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
)


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


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


def launch_counts():
    """Every kernel's launch count, by the names of the JSON line."""
    S, S4, G, G4, G3, E = _mods()
    return dict(select=S.launches, select_by_index=S.launches_by_index,
                select4=S4.launches, select4_by_index=S4.launches_by_index,
                merge=G.launches, merge4=G4.launches, merge3=G3.launches,
                esf=E.launches)


def zero_launch_counts():
    S, S4, G, G4, G3, E = _mods()
    S.launches = S.launches_by_index = 0
    S4.launches = S4.launches_by_index = 0
    G.launches = G4.launches = G3.launches = E.launches = 0


def bound(stats, name, n_bytes, n_ops):
    """The least time of the work on this card: bytes moved over the memory
    rate or float32 operations over the peak rate, the larger."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_F32_OPS * 1e3
    stats[name].update(bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations")


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
    return int(bad.sum()), float(torch.where(bad, 0.0, errs).max())


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


def candidate_tests(w, near, cap):
    """The candidate tests the greedy merge of this pool makes: at each
    pick, one for every remaining live candidate of every particle still
    picking. near(pick [P, 1]) -> [P, K] bool is the merge's test."""
    import torch
    w_rem = w.clone()
    col = torch.arange(w.shape[1], device=w.device)
    tests = 0
    for _ in range(cap):
        pick = torch.argmax(w_rem, dim=1, keepdim=True)
        active = torch.gather(w_rem, 1, pick) > 0.0
        if not bool(active.any()):
            break
        live = w_rem > 0.0
        tests += int((live & active).sum())
        sel = ((near(pick) & live) | (col[None, :] == pick)) & active
        w_rem = torch.where(sel, 0.0, w_rem)
    return tests


def merge_tests(pool, sep, cap, metric):
    import torch
    G = _mods()[2]
    w, mx, my, c00, c01, c11 = pool

    def near(pick):
        take = lambda a: torch.gather(a, 1, pick)
        return G._near(metric, take(mx) - mx, take(my) - my, take(c00),
                       take(c01), take(c11), c00, c01, c11, sep)
    return candidate_tests(w, near, cap)


def phase_merge(dev, stats):
    G = _mods()[2]
    t0 = time.perf_counter()
    _new_stats(stats, "merge")
    for i, (P, K, cap, metric, sep) in enumerate(MERGE_CASES):
        pool = random_pool(P, K, 10 + i, dev)
        kern = G.merge_cuda(*pool, sep, cap, metric)
        plain = G.merge_plain(*pool, sep, cap, metric)
        n_bad, err = compare_rows(kern, plain)
        _err(stats, "merge", err)
        log(f"merge [{P}, {K}] -> {cap} metric {metric}: particles "
            f"differing {n_bad}/{P}, max_abs_err {err:.3e}, live slots "
            f"{int((plain[0] > 0).sum(1).max())} max")
        _limit(n_bad, P, f"merge metric {metric}")
        if i == 0:                  # the dense pool
            s = stats["merge"]
            s.update(ms=cuda_ms(lambda: G.merge_cuda(*pool, sep, cap,
                                                     metric), 5),
                     plain_ms=cuda_ms(lambda: G.merge_plain(
                         *pool, sep, cap, metric), 2), library_ms=None)
            tests = merge_tests(pool, sep, cap, metric)
            bound(stats, "merge", 4 * 6 * P * (K + cap),
                  tests * MERGE_TEST_OPS)
            log(f"merge timing [{P}, {K}] -> {cap}: {s['ms']:.3f} ms "
                f"(plain {s['plain_ms']:.3f} ms, bound {s['bound_ms']:.4f} "
                f"ms by {s['bound_by']}, {tests} candidate tests)")
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
    import torch
    from phdslam_tpu_torch.ops.linalg import chol4_quad
    w, mean, cov = pool

    def near(pick):
        take = lambda a: torch.gather(a, 1, pick)
        a = [0.5 * (take(cov[:, q]) + cov[:, q]) for q in range(10)]
        d = [take(mean[:, k]) - mean[:, k] for k in range(4)]
        return chol4_quad(a, d) < sep
    return candidate_tests(w, near, cap)


def phase_merge4(dev, stats):
    G4 = _mods()[3]
    t0 = time.perf_counter()
    _new_stats(stats, "merge4")
    for i, (P, K, cap, sep) in enumerate(MERGE4_CASES):
        pool = random_pool4(P, K, 30 + i, dev)
        kern = G4.merge4_cuda(*pool, sep, cap)
        plain = G4.merge4_plain(*pool, sep, cap)
        n_bad, err = compare_rows(kern, plain)
        _err(stats, "merge4", err)
        log(f"merge4 [{P}, {K}] -> {cap} min_sep {sep}: particles "
            f"differing {n_bad}/{P}, max_abs_err {err:.3e}, live slots "
            f"{int((plain[0] > 0).sum(1).max())} max")
        _limit(n_bad, P, f"merge4 min_sep {sep}")
        if i == 0:                  # the dense pool at the shipped gate
            s = stats["merge4"]
            s.update(ms=cuda_ms(lambda: G4.merge4_cuda(*pool, sep, cap), 5),
                     plain_ms=cuda_ms(lambda: G4.merge4_plain(*pool, sep,
                                                              cap), 2),
                     library_ms=None)
            tests = merge4_tests(pool, sep, cap)
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
    return candidate_tests(w, near, cap)


def phase_merge3(dev, stats):
    G3 = _mods()[4]
    t0 = time.perf_counter()
    _new_stats(stats, "merge3")
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


def phase_esf(dev, stats):
    import torch
    E = _mods()[5]
    t0 = time.perf_counter()
    _new_stats(stats, "esf")
    for i, (P, M, pad) in enumerate(ESF_CASES):
        rng = np.random.default_rng(50 + i)
        # log Lambda_m as the CPHD update makes them: log detection mass +
        # log(clutter rate / clutter density), a few units around 0
        ll = rng.normal(-1.0, 2.0, (P, M)).astype(np.float32)
        if pad:
            ll[:, M - pad:] = -np.inf
        ll = torch.as_tensor(ll, device=dev)
        kern = E.esf_all_cuda(ll)
        plain = E.esf_all_plain(ll)
        n_bad, err = esf_agree(kern, plain)
        _err(stats, "esf", err)
        _limit(n_bad, P, f"esf [{P}, {M}]")
        case = dict(ms=cuda_ms(lambda: E.esf_all_cuda(ll), 10),
                    plain_ms=cuda_ms(lambda: E.esf_all_plain(ll), 3),
                    library_ms=None)
        n_lae = esf_logaddexps(ll)
        one = {"esf": case}
        bound(one, "esf", 4 * P * (M + (M + 1) + M * M), n_lae * LAE_OPS)
        log(f"esf [{P}, {M}] ({pad} padded slots): particles differing "
            f"{n_bad}/{P}, max_abs_err {err:.3e}; {case['ms']:.4f} ms "
            f"(plain {case['plain_ms']:.3f} ms, bound {case['bound_ms']:.4f}"
            f" ms by {case['bound_by']}, {n_lae} logaddexps)")
        if i == 0:                  # the dense CPHD shape goes to the JSON
            stats["esf"].update(case)
    log(f"phase esf: ok ({time.perf_counter() - t0:.1f} s)")


# --------------------------------------------- the kernels on real inputs --

class _KernelTimer:
    """Record CUDA events around every launch of one kernel wrapper, and
    the arguments of the last launch."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.pairs = []
        self.last_args = None

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
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def ms(self):
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def timers():
    """One _KernelTimer per kernel wrapper: select (both modes), select4
    (both modes), merge, merge4, merge3, esf."""
    S, S4, G, G4, G3, E = _mods()
    return dict(select=_KernelTimer(S, "select_cuda"),
                select4=_KernelTimer(S4, "select4_cuda"),
                merge=_KernelTimer(G, "merge_cuda"),
                merge4=_KernelTimer(G4, "merge4_cuda"),
                merge3=_KernelTimer(G3, "merge3_cuda"),
                esf=_KernelTimer(E, "esf_all_cuda"))


def agree_on_last_args(tm, stats, what):
    """Run every kernel the timers saw, and its plain version, again on the
    arguments of its last launch."""
    S, S4, G, G4, G3, E = _mods()
    plain_of = dict(select=S.select_plain, select4=S4.select4_plain,
                    merge=G.merge_plain, merge4=G4.merge4_plain,
                    merge3=G3.merge3_plain, esf=E.esf_all_plain)
    parts = []
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
        else:
            n_bad, err = compare_rows(kern, plain)
        P = kern[0].shape[0]
        key = name + ("_by_index" if by else "")
        _limit(n_bad, P, f"{key} ({what} inputs)")
        _new_stats(stats, key)
        _err(stats, key, err)
        parts.append(f"{key} {'x'.join(map(str, kern[1].shape))} "
                     f"{n_bad}/{P} (max_abs_err {err:.3e})")
    log(f"{what} inputs, kernels against plain, particles differing: "
        + "; ".join(parts))


def run_cli(args, tm):
    """runner.main(args) with every launch count set to 0 just before and
    every timer on; returns (launch counts, run seconds)."""
    from contextlib import ExitStack

    from phdslam_tpu_torch import runner
    zero_launch_counts()
    t_run = time.perf_counter()
    with ExitStack() as stack:
        for t in tm.values():
            stack.enter_context(t)
        runner.main(args)
    return launch_counts(), time.perf_counter() - t_run


def run_runner(d, cfg_text, steps_cfg, dev, tm):
    """The synth runner in loop mode on the run files in d; returns (launch
    counts, run seconds, out dir)."""
    Path(d, "run.cfg").write_text(cfg_text + steps_cfg)
    out = Path(d, f"out{len(list(Path(d).glob('out*')))}")
    args = [str(Path(d, "run.cfg")), "synth", "--measurements",
            str(Path(d, "measurements.txt")), "--controls",
            str(Path(d, "controls.txt")), "--data-dir", str(d),
            "--out-dir", str(out), "--mode", "loop", "--device", dev.type]
    launches, run_s = run_cli(args, tm)
    return launches, run_s, out


def check_launches(launches, expect, what):
    for k, v in expect.items():
        if launches[k] != v:
            raise RuntimeError(f"{what}: {k} launched {launches[k]} times, "
                               f"expected {v}")


# ------------------------------------------------- phase 3: main path --

def phase_main_path(dev, stats):
    from phdslam_tpu_torch import simdata
    from phdslam_tpu_torch.io.logs import read_state_estimate_log

    t0 = time.perf_counter()
    sc = simdata.make_scenario(np.random.default_rng(0), n_steps=RUN_STEPS)
    controls, meas = simdata.generate_run(np.random.default_rng(1), sc,
                                          control_noise=(0.2, 0.01))
    n_steps = len(meas)
    if not all(len(z) for z in meas):
        raise RuntimeError("scenario has a step without measurements")
    tm = timers()
    with tempfile.TemporaryDirectory() as d:
        simdata.write_run_files(d, controls, meas)
        x0, y0, yaw0 = sc.traj[0]
        launches, run_s, out = run_runner(
            d, (ROOT / "cfg/ackerman_synth.cfg").read_text(),
            f"\ninitial_x = {x0}\ninitial_y = {y0}\ninitial_yaw = {yaw0}\n",
            dev, tm)
        n_logs = len(list(out.glob("state_estimate*.log")))
        loop_ms = np.loadtxt(out / "loopTime.log")
        errs = np.array([np.linalg.norm(read_state_estimate_log(
            str(out / f"state_estimate{t:05d}.log"))["pose"][:2]
            - sc.traj[t, :2]) for t in range(n_steps)])
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
                                  esf=0),
                   "static main path")
    if not np.isfinite(errs).all() or errs.mean() >= POSE_BAR_M:
        raise RuntimeError(f"mean pose error {errs.mean():.3f} m is not "
                           f"below {POSE_BAR_M} m")
    agree_on_last_args(tm, stats, "static main path")
    log(f"main path kernels: select {tm['select'].ms() / n_steps:.4f} "
        f"ms/step, merge {tm['merge'].ms() / n_steps:.4f} ms/step (CUDA "
        f"events)")
    for k in ("select", "merge"):
        stats[k]["launches"] = launches[k]
    stats["shipped_ms_per_step"] = float(loop_ms.mean())
    log(f"phase main path: ok ({time.perf_counter() - t0:.1f} s)")


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


def phase_mixed_main_path(dev, stats):
    from phdslam_tpu_torch import load_config, simdata
    from phdslam_tpu_torch.io.logs import read_state_estimate_log

    t0 = time.perf_counter()
    sc = simdata.make_scenario(np.random.default_rng(11),
                               n_landmarks=MIXED_LANDMARKS,
                               n_steps=MIXED_STEPS)
    controls, meas, truth = simdata.generate_mixed_run(
        np.random.default_rng(500), sc, MOVER0, MOVER_V,
        control_noise=(0.2, 0.01))
    n_steps = len(meas)
    if not all(len(z) for z in meas):
        raise RuntimeError("mixed scenario has a step without measurements")
    base = (ROOT / "cfg/mixed_synth.cfg").read_text()
    cfg = load_config(str(ROOT / "cfg/mixed_synth.cfg"))
    x0, y0, yaw0 = sc.traj[0]
    start = f"\ninitial_x = {x0}\ninitial_y = {y0}\ninitial_yaw = {yaw0}\n"
    tm = timers()
    with tempfile.TemporaryDirectory() as d:
        simdata.write_run_files(d, controls, meas)
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
                                      select4_by_index=0, merge3=0, esf=0),
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

        # the by-index modes, on the first steps of the same run
        tm = timers()
        launches, run_s, out = run_runner(
            d, base, start + f"n_steps = {BY_INDEX_STEPS}\n"
            "select_by_index = 1\n", dev, tm)
        check_launches(launches, dict(
            select_by_index=BY_INDEX_STEPS, select4_by_index=BY_INDEX_STEPS,
            merge=BY_INDEX_STEPS, merge4=BY_INDEX_STEPS, select=0,
            select4=0), "select_by_index pass")
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

def phase_disparity_main_path(dev, stats):
    from phdslam_tpu_torch.io.logs import read_state_estimate_log

    t0 = time.perf_counter()
    data = ROOT / "data/disparity_synth"
    traj = np.loadtxt(data / "traj.txt", comments="%")
    tm = timers()
    with tempfile.TemporaryDirectory() as d:
        out = Path(d, "out")
        launches, run_s = run_cli(
            [str(ROOT / "cfg/disparity_synth.cfg"), "disparity",
             "--data-dir", str(data), "--out-dir", str(out), "--mode",
             "loop", "--device", dev.type], tm)
        loop_ms = np.loadtxt(out / "loopTime.log")
        n_steps = len(loop_ms)
        metrics = [json.loads(x) for x in
                   (out / "metrics.jsonl").read_text().splitlines()]
        logs = [read_state_estimate_log(str(out / f"state_estimate{t:05d}"
                                            ".log")) for t in range(n_steps)]
    n_update = sum(m["n_measure"] > 0 for m in metrics)
    errs = np.array([np.linalg.norm(lg["pose"][:3] - traj[t, :3])
                     for t, lg in enumerate(logs)])
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
                                  select4_by_index=0, merge4=0, esf=0),
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
    from phdslam_tpu_torch import simdata
    from phdslam_tpu_torch.io.logs import read_state_estimate_log

    t0 = time.perf_counter()
    sc = simdata.make_scenario(np.random.default_rng(0), n_steps=RUN_STEPS)
    controls, meas = simdata.generate_run(np.random.default_rng(1), sc,
                                          control_noise=(0.2, 0.01))
    n_steps = len(meas)
    tm = timers()
    with tempfile.TemporaryDirectory() as d:
        simdata.write_run_files(d, controls, meas)
        x0, y0, yaw0 = sc.traj[0]
        launches, run_s, out = run_runner(
            d, (ROOT / "cfg/ackerman_synth.cfg").read_text(),
            f"\ninitial_x = {x0}\ninitial_y = {y0}\ninitial_yaw = {yaw0}\n"
            "filter_type = 1\n", dev, tm)
        loop_ms = np.loadtxt(out / "loopTime.log")
        logs = [read_state_estimate_log(str(out / f"state_estimate{t:05d}"
                                            ".log")) for t in range(n_steps)]
    errs = np.array([np.linalg.norm(lg["pose"][:2] - sc.traj[t, :2])
                     for t, lg in enumerate(logs)])
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
                                  merge3=0), "CPHD main path")
    if not tm["select"].last_args[1].get("raw"):
        raise RuntimeError("CPHD: the select kernel ran outside raw mode")
    if not np.isfinite(errs).all() or errs.mean() >= POSE_BAR_M:
        raise RuntimeError(f"CPHD: mean pose error {errs.mean():.3f} m is "
                           f"not below {POSE_BAR_M} m")
    agree_on_last_args(tm, stats, "CPHD main path")
    log(f"CPHD main path kernels (CUDA events, ms/step): " + ", ".join(
        f"{k} {t.ms() / n_steps:.4f}" for k, t in tm.items() if t.pairs))
    stats["esf"]["launches"] = launches["esf"]
    stats["cphd_ms_per_step"] = float(loop_ms.mean())
    log(f"phase CPHD main path: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------ phases 7-9: dense steps --

def stress_inputs(cfg, n_steps, seed=0):
    """bench.py's clutter-heavy stream (make_stress_inputs), same seed and
    formula: 90 % of the slots hold uniform clutter each step."""
    rng = np.random.default_rng(seed)
    m = cfg.maxMeasurements
    rb = np.zeros((n_steps, m, 2), np.float32)
    valid = np.zeros((n_steps, m), bool)
    k = int(m * 0.9)
    rb[:, :k, 0] = rng.uniform(0.5, cfg.maxRange, (n_steps, k))
    rb[:, :k, 1] = rng.uniform(-cfg.maxBearing, cfg.maxBearing,
                               (n_steps, k))
    valid[:, :k] = True
    controls = np.zeros((n_steps, 2), np.float32)
    controls[:, 0] = 1.5
    controls[:, 1] = 0.1 * np.sin(np.arange(n_steps) / 10.0)
    return rb, valid, controls


def stress_stepper(shape, n_steps, dev, dense=True,
                   cfg_file="cfg/ackerman_synth.cfg", **overrides):
    """(cfg, state, step(state, t)) for a shipped cfg at a shape on the
    stress stream; dense adds bench.py's dense_stress_config overrides,
    then the given cfg overrides."""
    import torch
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.filter.state import Measurements, SlamState
    from phdslam_tpu_torch.filter.step import slam_step

    cfg = load_config(str(ROOT / cfg_file)).replace(
        n_particles=shape["P"], maxFeatures=shape["F"],
        maxMeasurements=shape["M"])
    if dense:
        cfg = cfg.replace(y0=0.0, birthWeight=1e-3, clutterRate=50.0)
    cfg = cfg.replace(**overrides)
    rb, valid, controls = stress_inputs(cfg, n_steps)
    label = np.zeros((cfg.maxMeasurements,), np.int32)
    zs = [Measurements.from_numpy(rb[t], label, valid[t], dev)
          for t in range(n_steps)]
    gen = torch.Generator(device=dev).manual_seed(0)

    def step(state, t):
        return slam_step(state, (float(controls[t, 0]),
                                 float(controls[t, 1])), zs[t],
                         float(cfg.dt), t > 0, cfg, generator=gen,
                         z_prev=zs[t - 1] if t > 0 else None)

    return cfg, SlamState.create(cfg, dev), step


def timed_steps(stats, state, step, warmup, what, shape):
    """warmup steps, then TIMED steps with CUDA events around the whole
    and around every kernel launch (glue is the remainder); logs the split
    and checks every kernel against its plain version on the last timed
    step's own inputs (real pools hold exact weight ties, e.g. births of
    measurements no feature explains). Returns (state, ms/step)."""
    import torch
    from contextlib import ExitStack
    for t in range(warmup):
        state, aux = step(state, t)
    torch.cuda.synchronize()
    tm = timers()
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
    k_ms = {k: t.ms() / TIMED for k, t in tm.items() if t.pairs}
    glue_ms = step_ms - sum(k_ms.values())
    neff = float(aux.neff)
    log(f"{what} {shape}: {step_ms:.3f} ms/step = pre-update and glue "
        f"{glue_ms:.3f} + " + " + ".join(
            f"{k} kernel {v:.3f}" for k, v in k_ms.items())
        + f" (neff {neff:.4f})")
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


def disparity_stepper(shape, n_steps, dev):
    """(state, step(state, t)) of the disparity cfg widened to shape on the
    shipped measurement stream (data/disparity_synth/), with the runner's
    initial roll and yaw jitter."""
    import torch
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.filter.disparity import (DisparityState,
                                                    disparity_step)
    from phdslam_tpu_torch.filter.state import Measurements
    from phdslam_tpu_torch.io import loaders

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
                              generator=gen)

    return state.replace(pose=pose), step


def phase_dense_cphd_disparity(dev, stats, gpu):
    """The two stress shapes of this slice (not shipped cfgs): CPHD at
    BASELINE config 3's shape and the disparity step at 8192 particles."""
    import torch
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
    torch.cuda.reset_peak_memory_stats()
    state, step = disparity_stepper(DENSE_DISP, DISP_WARMUP + TIMED, dev)
    state, ms = timed_steps(stats, state, step, DISP_WARMUP,
                            "dense disparity step",
                            "x".join(str(DENSE_DISP[k]) for k in "PFM")
                            + " x 64 points")
    stats["dense_disparity_ms_per_step"] = ms
    log(f"dense disparity step: max live map slots "
        f"{int((state.w > 0).sum(1).max())}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"dense timing on {gpu}: CPHD step "
        f"{stats['dense_cphd_ms_per_step']:.3f} ms, disparity step "
        f"{stats['dense_disparity_ms_per_step']:.3f} ms")
    log(f"phase dense disparity: ok ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------- optional: --profile --

def phase_profile(dev):
    """torch.profiler over PROFILED steps, after PROFILE_WARMUP steps, of
    the static step at the dense and the shipped shape (stress stream), the
    dense CPHD step and the dense disparity step (phase 9's shapes).
    Prints the host wall time per step (without the profiler), the device's
    busy share of the profiled window (the union of its kernel and copy
    intervals) and the ops and kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
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
         lambda: disparity_stepper(DENSE_DISP, n, dev)))
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
        events = prof.events()
        on_dev = sorted((e.time_range.start, e.time_range.end)
                        for e in events if e.device_type == DeviceType.CUDA)
        lo = min(e.time_range.start for e in events)
        hi = max(e.time_range.end for e in events)
        busy, reach = 0.0, lo
        for a, b in on_dev:         # union of the device intervals, in us
            busy += max(0.0, b - max(a, reach))
            reach = max(reach, b)
        dims = "x".join(str(shape[k]) for k in "PFM")
        busy_ms = busy / 1e3 / PROFILED
        # the profiler slows the host, so the window overstates the idle
        # share; the device's work is the same with it off
        log(f"profile {name} {dims}: host wall {wall_ms:.3f} ms/step "
            f"(profiler off); device busy {busy_ms:.3f} ms/step = "
            f"{busy_ms / wall_ms:.1%} of that wall, {busy / (hi - lo):.1%} "
            f"of the profiled window ({(hi - lo) / 1e3 / PROFILED:.3f} "
            f"ms/step); {len(on_dev) / PROFILED:.0f} device activities/step")
        # ops that launch device work, and our kernels (launched outside
        # any op): device time of each per step
        rows = [e for e in prof.key_averages() if e.self_device_time_total
                > 0 and (e.device_type == DeviceType.CPU
                         or "_kernel" in e.key and "at::" not in e.key)]
        rows.sort(key=lambda e: -e.self_device_time_total)
        for e in rows[:PROFILE_ROWS]:
            log(f"  {e.self_device_time_total / 1e3 / PROFILED:8.3f} ms/step"
                f"  {e.count / PROFILED:5.1f} calls/step  {e.key[:70]}")
    log(f"phase profile: ok ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------------------------ main --

def main(argv=None):
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the static step (dense and shipped "
                    "shape) and the dense CPHD and disparity steps with "
                    "torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "phdslam_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no phdslam_tpu_torch package beside {__file__};"
              " run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
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
    phase_select(dev, stats)
    phase_merge(dev, stats)
    phase_select4(dev, stats)
    phase_merge4(dev, stats)
    phase_merge3(dev, stats)
    phase_esf(dev, stats)
    phase_main_path(dev, stats)
    phase_mixed_main_path(dev, stats)
    phase_disparity_main_path(dev, stats)
    phase_cphd_main_path(dev, stats)
    phase_dense(dev, stats, gpu)
    phase_dense_cphd_disparity(dev, stats, gpu)
    if args.profile:
        phase_profile(dev)

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

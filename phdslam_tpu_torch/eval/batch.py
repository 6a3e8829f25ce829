"""Monte-Carlo batch harness and error analysis: the port's counterpart of
``phdslam_tpu/eval/batch.py``.

``run_batch`` filters ``n_runs`` independent re-noisings of one
``simdata.Scenario`` end to end and scores each: the pose error per step
and the OSPA of the MAP particle's map against the landmarks visited so
far. Run r is re-noised with ``default_rng(seed + 1000 r)``, as in JAX, so
both packages filter the same data bit for bit; its filter draws from
``torch.Generator(device).manual_seed(seed + r)`` (JAX's ``PRNGKey(seed +
r)``: the streams differ, the statistics do not). By default runs go one
after another through ``filter/step.py::run_scan``; with ``vmapped=True``
a chunk of runs goes through it together, blockwise on the particle axis
(``filter/runs.py``): one step of every run of the chunk at a time, each
kernel launched once per step for the whole chunk. Run r draws from its
own generator in the single run's order, so both paths filter the same
draws, and the chunking changes no run.

The helpers (``RunResult``, ``analyze_run``, ``visited_landmarks``,
``_map_ospa_curve``, ``_prepare_run``, ``_analyze_one``, ``aggregate``,
``analyze_log_dir``) are host numpy code, copied from the JAX package with
the port's own ``simdata``, ``io/loaders``, ``io/logs`` and ``ops/ospa``.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from phdslam_tpu_torch.ops.ospa import ospa_np


@dataclass
class RunResult:
    poses: np.ndarray          # [T, 6] expected poses
    pose_err: np.ndarray       # [T]
    ospa: np.ndarray           # [T, 3] (ospa, loc, card) or NaN if no gt map
    neff: np.ndarray           # [T]
    ms_per_step: float
    card_est: Optional[np.ndarray] = None   # [T] estimated total-map
    #   cardinality: sum of the MAP particle's GM weights (the intensity
    #   integral) for BOTH filter types (the reference logs the weight
    #   list + cardinality pmf for offline scoring, main.cpp:937-952)
    card_true: Optional[np.ndarray] = None  # [T] visited-landmark count
    card_en: Optional[np.ndarray] = None    # [T] CPHD only: E[n] of the
    #   MAP particle's posterior pmf — the in-range-submap cardinality
    #   statistic (see cphd.psi_terms), kept for diagnostics


def analyze_run(poses, true_traj, map_estimates=None, true_maps=None,
                p=1.0, c=5.0):
    """Per-step pose error and OSPA (batch_analyze.py:16-35 semantics:
    pose error on (x, y); map thresholded by round(sum w) top weights)."""
    t_len = min(len(poses), true_traj.shape[0])
    pose_err = np.linalg.norm(
        np.asarray(poses)[:t_len, :2] - true_traj[:t_len, :2], axis=1)
    ospa = np.full((t_len, 3), np.nan)
    if map_estimates is not None and true_maps is not None:
        for t in range(t_len):
            w, mean = map_estimates[t]
            gt = true_maps[t]
            if gt is None or len(gt) == 0:
                continue
            sel = np.argsort(-w)[: int(round(w.sum()))]
            ospa[t] = ospa_np(gt, mean[sel], p=p, c=c)
    return pose_err, ospa


def visited_landmarks(scenario) -> List[np.ndarray]:
    """Per-step ground-truth maps: the landmarks that have entered the
    sensor FOV at any step <= t — the semantics of the reference's
    sim.groundTruth[t].loc (SynthSetup2.m builds it cumulatively; OSPA in
    batch_analyze.py:26-33 scores against it)."""
    seen = np.zeros(scenario.landmarks.shape[0], bool)
    out = []
    for pose in scenario.traj:
        d = scenario.landmarks - pose[:2]
        r = np.linalg.norm(d, axis=1)
        b = np.arctan2(d[:, 1], d[:, 0]) - pose[2]
        b = np.arctan2(np.sin(b), np.cos(b))
        seen |= ((r >= scenario.min_range) & (r <= scenario.max_range)
                 & (np.abs(b) <= scenario.max_bearing))
        out.append(scenario.landmarks[seen].copy())
    return out


def _map_ospa_curve(log_auxs, true_maps, every: int, t_len: int,
                    p=1.0, c=5.0) -> np.ndarray:
    """OSPA of the per-step MAP-particle map (thresholded the
    batch_analyze.py:26-28 way) vs the per-step visited-landmark truth."""
    ospa = np.full((t_len, 3), np.nan)
    w_all = np.asarray(log_auxs.map_w)
    mx_all = np.asarray(log_auxs.map_mx)
    my_all = np.asarray(log_auxs.map_my)
    # always score the final step so batch_metrics' final_ospa really is
    # the run's last step, whatever the stride
    steps = sorted(set(range(0, t_len, max(every, 1))) | {t_len - 1})
    for t in steps:
        gt = true_maps[min(t, len(true_maps) - 1)]
        w = w_all[t]
        n_est = int(round(float(w.sum())))
        sel = np.argsort(-w)[: max(n_est, 0)]
        est = np.stack([mx_all[t][sel], my_all[t][sel]], axis=-1)
        ospa[t] = ospa_np(gt, est, p=p, c=c)
    return ospa


def _prepare_run(cfg, scenario, run: int, seed: int,
                 control_noise, t_len: int):
    """Host-side re-noising for one MC run: (ctrl [T,2], rb [T,M,2],
    labels [T,M], valid [T,M]) numpy arrays. Seeding is the run_batch
    contract: run r uses default_rng(seed + 1000*r)."""
    from phdslam_tpu_torch.io.loaders import (MeasurementSet,
                                              pad_measurement_sets)
    from phdslam_tpu_torch.simdata import generate_run

    rng = np.random.default_rng(seed + 1000 * run)
    controls, meas = generate_run(rng, scenario, control_noise)
    sets = [MeasurementSet(z[:, 0], z[:, 1],
                           np.zeros(len(z), np.int32)) for z in meas]
    rb, labels, valid = pad_measurement_sets(sets, cfg.maxMeasurements)
    ctrl = np.zeros((t_len, 2), np.float32)
    ctrl[1:] = controls[: t_len - 1]
    return ctrl, rb[:t_len], labels[:t_len], valid[:t_len]


def _analyze_one(run: int, poses, auxs_neff, log_auxs, true_maps,
                 collect_maps_every: int, scenario, ms_per_step: float,
                 out_dir: Optional[str]) -> RunResult:
    """Shared per-run post-processing (host): pose error, map OSPA curve,
    optional metrics JSONL line."""
    t_len = scenario.traj.shape[0]
    pose_err, _ = analyze_run(poses, scenario.traj)
    card_est = card_true = card_en = None
    if log_auxs is not None:
        ospa = _map_ospa_curve(log_auxs, true_maps,
                               collect_maps_every, t_len)
        # Total-map cardinality estimate = the MAP particle's intensity
        # mass, for BOTH filter types. The CPHD posterior pmf is the
        # in-range-submap statistic (the reference updates it against
        # in-FOV evidence only, phdfilter.cu.bak:2536-2541 — see
        # cphd.psi_terms); its E[n] tracks the currently-detectable
        # count, not the accumulated map, so it is kept separately.
        card_est = np.asarray(log_auxs.map_w).sum(-1)[:t_len]
        cn = np.asarray(log_auxs.cardinality)            # [T, N+1] or [T, 1]
        if cn.shape[-1] > 1:
            pmf = np.exp(cn - cn.max(-1, keepdims=True))
            pmf /= pmf.sum(-1, keepdims=True)
            card_en = (pmf * np.arange(cn.shape[-1])).sum(-1)[:t_len]
        else:
            card_en = None
        if true_maps is not None:
            card_true = np.asarray(
                [len(true_maps[min(t, len(true_maps) - 1)])
                 for t in range(t_len)], np.float64)
    else:
        ospa = np.full((t_len, 3), np.nan)
    result = RunResult(poses=poses, pose_err=pose_err, ospa=ospa,
                       neff=auxs_neff, ms_per_step=ms_per_step,
                       card_est=card_est, card_true=card_true,
                       card_en=card_en)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        scored = ospa[np.isfinite(ospa[:, 0])]
        with open(os.path.join(out_dir, "batch_metrics.jsonl"), "a") as f:
            f.write(json.dumps(dict(
                run=run, mean_pose_err=float(pose_err.mean()),
                final_pose_err=float(pose_err[-1]),
                mean_ospa=float(scored[:, 0].mean())
                if scored.size else None,
                final_ospa=float(scored[-1, 0])
                if scored.size else None,
                mean_card_err=float(np.abs(card_est - card_true).mean())
                if card_est is not None and card_true is not None else None,
                final_card_err=float(abs(card_est[-1] - card_true[-1]))
                if card_est is not None and card_true is not None else None,
                ms_per_step=ms_per_step)) + "\n")
    return result


def run_batch(cfg, scenario, n_runs: int, control_noise=(0.2, 0.01),
              seed: int = 0, out_dir: Optional[str] = None,
              collect_maps_every: int = 1, vmapped: bool = False,
              vmap_chunk: int = 0, device="cuda") -> List[RunResult]:
    """Monte-Carlo batch: ``n_runs`` independent re-noisings of
    ``scenario``, each filtered end to end on ``device`` (CUDA unless the
    caller asks for the CPU). Returns per-run results; with ``out_dir``
    also appends one ``batch_metrics.jsonl`` line per run.

    ``ms_per_step`` is a run's wall time, from before its first step to the
    host copy of its poses, over its steps. ``collect_maps_every = k``
    scores the map OSPA (against the cumulative visited-landmark truth)
    every k steps and at the last; 0 disables map scoring (pose error
    only).

    ``vmapped=True`` filters ``vmap_chunk`` runs at a time together (0:
    65536 // n_particles runs, JAX's default), the chunk's measurements
    and controls copied to the device once and its results back once;
    ``ms_per_step`` is then the chunk's wall time over its steps and
    runs. Each run filters what it filters on the sequential path."""
    import torch

    from phdslam_tpu_torch.filter.state import Measurements, SlamState
    from phdslam_tpu_torch.filter.step import run_scan

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"run_batch(device={device!r}): CUDA is not "
                           "available; pass device='cpu' to run the kernels' "
                           "plain versions on the CPU")
    t_len = scenario.traj.shape[0]
    # particles must start where the scenario's trajectory starts
    cfg = cfg.replace(x0=float(scenario.traj[0, 0]),
                      y0=float(scenario.traj[0, 1]),
                      yaw0=float(scenario.traj[0, 2]))
    true_maps = visited_landmarks(scenario) if collect_maps_every else None
    with_log = collect_maps_every > 0
    dts = np.full((t_len,), cfg.dt, np.float32)
    if vmapped:
        return _run_chunks(cfg, scenario, n_runs, control_noise, seed,
                           out_dir, collect_maps_every, vmap_chunk, dev,
                           true_maps, dts)

    results = []
    for run in range(n_runs):
        ctrl, rb, labels, valid = _prepare_run(
            cfg, scenario, run, seed, control_noise, t_len)
        zs = [Measurements.from_numpy(rb[t], labels[t], valid[t], dev)
              for t in range(t_len)]
        generator = torch.Generator(device=dev).manual_seed(seed + run)
        state = SlamState.create(cfg, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = run_scan(state, ctrl, zs, dts, cfg, generator=generator,
                       with_log_state=with_log)
        auxs, log_auxs = out[1] if with_log else (out[1], None)
        poses = auxs.expected_pose.cpu().numpy()     # waits for the device
        elapsed = time.perf_counter() - t0
        if log_auxs is not None:
            log_auxs = type(log_auxs)(*(t.cpu().numpy() for t in log_auxs))
        results.append(_analyze_one(
            run, poses, auxs.neff.cpu().numpy(), log_auxs, true_maps,
            collect_maps_every, scenario, elapsed / t_len * 1000, out_dir))
    return results


def chunk_inputs(cfg, scenario, runs, seed, control_noise, device):
    """The inputs of a chunk of runs (``run_batch``'s seeding): controls
    [T, R, 2] on the host, T per-run Measurements [R, M, ...] (one copy to
    the device for the chunk) and the runs' R generators."""
    import torch

    from phdslam_tpu_torch.filter.state import Measurements

    t_len = scenario.traj.shape[0]
    prep = [_prepare_run(cfg, scenario, r, seed, control_noise, t_len)
            for r in runs]
    ctrl = np.stack([p[0] for p in prep], 1)                   # [T, R, 2]
    rb, labels, valid = (np.stack([p[i] for p in prep], 1)
                         for i in (1, 2, 3))             # [T, R, M(, 2)]
    rb_d, labels_d, valid_d = (torch.as_tensor(a, device=device)
                               for a in (rb, labels, valid))
    zs = [Measurements(rb=rb_d[t], label=labels_d[t], valid=valid_d[t],
                       count=tuple(int(c) for c in valid[t].sum(-1)))
          for t in range(t_len)]
    generators = [torch.Generator(device=device).manual_seed(seed + r)
                  for r in runs]
    return ctrl, zs, generators


def _run_chunks(cfg, scenario, n_runs, control_noise, seed, out_dir,
                collect_maps_every, vmap_chunk, dev, true_maps, dts):
    """run_batch's vmapped path: chunks of runs through one run_scan."""
    import torch

    from phdslam_tpu_torch.filter.state import SlamState
    from phdslam_tpu_torch.filter.step import run_scan

    t_len = scenario.traj.shape[0]
    with_log = collect_maps_every > 0
    if vmap_chunk <= 0:
        vmap_chunk = max(1, 65536 // max(cfg.n_particles, 1))
    results = []
    for start in range(0, n_runs, vmap_chunk):
        runs = list(range(start, min(start + vmap_chunk, n_runs)))
        ctrl, zs, generators = chunk_inputs(cfg, scenario, runs, seed,
                                            control_noise, dev)
        state = SlamState.create(cfg, dev, n_runs=len(runs))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = run_scan(state, ctrl, zs, dts, cfg, generator=generators,
                       with_log_state=with_log)
        auxs, log_auxs = out[1] if with_log else (out[1], None)
        poses = auxs.expected_pose.cpu().numpy()   # [T, R, 6]; waits
        elapsed = time.perf_counter() - t0
        ms = elapsed / (t_len * len(runs)) * 1000
        neffs = auxs.neff.cpu().numpy()
        if log_auxs is not None:                   # one bulk copy
            log_auxs = type(log_auxs)(*(t.cpu().numpy() for t in log_auxs))
        for i, run in enumerate(runs):
            la = (type(log_auxs)(*(x[:, i] for x in log_auxs))
                  if log_auxs is not None else None)
            results.append(_analyze_one(
                run, poses[:, i], neffs[:, i], la, true_maps,
                collect_maps_every, scenario, ms, out_dir))
    return results


def aggregate(results: List[RunResult]):
    """Mean +- std error envelopes over runs (plot_results.py:21-66):
    pose error plus the OSPA / localization / cardinality error curves."""
    t_len = min(len(r.pose_err) for r in results)
    pe = np.stack([r.pose_err[:t_len] for r in results])
    out = dict(
        pose_err_mean=pe.mean(0), pose_err_std=pe.std(0),
        ms_per_step=[r.ms_per_step for r in results])
    if all(r.card_est is not None and r.card_true is not None
           for r in results):
        ce = np.stack([np.abs(r.card_est[:t_len] - r.card_true[:t_len])
                       for r in results])                 # [R, T]
        out.update(card_err_mean=ce.mean(0), card_err_std=ce.std(0),
                   card_true=results[0].card_true[:t_len])
    os_ = np.stack([r.ospa[:t_len] for r in results])     # [R, T, 3]
    if np.isfinite(os_).any():
        with np.errstate(invalid="ignore"):
            out.update(
                ospa_mean=np.nanmean(os_[:, :, 0], 0),
                ospa_std=np.nanstd(os_[:, :, 0], 0),
                loc_mean=np.nanmean(os_[:, :, 1], 0),
                loc_std=np.nanstd(os_[:, :, 1], 0),
                card_mean=np.nanmean(os_[:, :, 2], 0),
                card_std=np.nanstd(os_[:, :, 2], 0))
    return out


def analyze_log_dir(log_dir: str, true_traj, true_map=None, p=1.0, c=5.0):
    """Offline analysis of a directory of state_estimate logs — the direct
    batch_analyze.py equivalent, working on the compatibility log format."""
    import glob

    from phdslam_tpu_torch.io.logs import read_state_estimate_log

    files = sorted(glob.glob(os.path.join(log_dir, "state_estimate*.log")))
    pose_err, ospa, neff = [], [], []
    for t, path in enumerate(files):
        d = read_state_estimate_log(path)
        pose_err.append(np.linalg.norm(d["pose"][:2] - true_traj[:2, t]))
        lw = d["weights"]
        neff.append(1.0 / np.sum(np.exp(lw) ** 2) / len(lw))
        if true_map is not None and d["static"].size:
            w = d["static"][:, 0]
            mean = d["static"][:, 1:3]
            sel = np.argsort(-w)[: int(round(w.sum()))]
            ospa.append(ospa_np(true_map, mean[sel], p=p, c=c))
        else:
            ospa.append((np.nan,) * 3)
    return (np.asarray(pose_err), np.asarray(ospa), np.asarray(neff))

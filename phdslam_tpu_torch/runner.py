"""Command-line entry point of the GM-PHD SLAM port.

    python -m phdslam_tpu_torch.runner <config.cfg> synth \\
        --measurements M.txt --controls C.txt --out-dir OUT \\
        [--mode loop|scan] [--device cuda|cpu] [--seed N]
    python -m phdslam_tpu_torch.runner <config.cfg> disparity \\
        [--data-dir D] --out-dir OUT [--mode loop|scan] [--device cuda|cpu]

It runs on the GPU (``--device cuda``, the default) and raises when CUDA is
missing; ``--device cpu`` runs the kernels' plain versions on the CPU.

Mirrors ``phdslam_tpu/runner.py::run_synth``: timestamp-interleaved input
scheduling when ``*_times.txt`` files exist and lockstep otherwise,
prediction skipped at step 0, the update only on steps with measurements,
and the same ``state_estimateXXXXX.log``, ``loopTime.log`` and
``metrics.jsonl`` files, written by ``io/logs.py`` (the JAX package's log
format). Under the dynamic and mixed feature models line 3 of each log holds
the dynamic map; under the CPHD filter (filter_type = 1) the last line holds
the MAP particle's cardinality log-pmf. The ``disparity`` run type runs the
monocular SC-PHD pipeline (``filter/disparity.py::run_disparity``).

``--mode loop`` steps in a Python loop and writes the logs after every step;
``--mode scan`` queues the whole run on the device, then writes the logs
from the stacked per-step outputs. The maps in the log are the MAP
particle's.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from phdslam_tpu_torch.config import CPHD_TYPE, load_config
from phdslam_tpu_torch.filter.disparity import run_disparity
from phdslam_tpu_torch.filter.state import Measurements, SlamState
from phdslam_tpu_torch.filter.step import (check_supported, log_aux,
                                           run_scan, slam_step)
from phdslam_tpu_torch.io import loaders, logs


def schedule_inputs(n_steps, meas_times, ctrl_times):
    """Per-step dict(z=measurement set, c=control index, dt, predict): the
    timestamp interleave when timestamps exist, else lockstep (measurement
    n with control n - 1). Same rule as ``phdslam_tpu.runner``."""
    sched = []
    if meas_times is None:
        for n in range(n_steps):
            sched.append(dict(z=n, c=n - 1 if n > 0 else None, dt=None,
                              predict=True))
        return sched
    z_idx, c_idx = 0, 0
    current_time = 0.0
    for _ in range(n_steps):
        if z_idx >= len(meas_times) or c_idx >= len(ctrl_times):
            break
        last = current_time
        if meas_times[z_idx] < ctrl_times[c_idx]:
            # measurement-only step: predict with the last consumed control
            current_time = ctrl_times[c_idx]
            sched.append(dict(z=z_idx, c=c_idx - 1 if c_idx > 0 else None,
                              dt=current_time - last, predict=True))
            z_idx += 1
        elif meas_times[z_idx] == ctrl_times[c_idx]:
            current_time = ctrl_times[c_idx]
            sched.append(dict(z=z_idx, c=c_idx, dt=current_time - last,
                              predict=True))
            z_idx += 1
            c_idx += 1
        else:
            current_time = ctrl_times[c_idx]
            sched.append(dict(z=None, c=c_idx, dt=current_time - last,
                              predict=True))
            c_idx += 1
    return sched


def check_run_supported(cfg, args):
    """Raise NotImplementedError for what the port's runner does not do
    yet, naming the ROADMAP item."""
    check_supported(cfg)
    later = "ROADMAP Queue 1 item 8"
    if cfg.mapEstimate & 2:
        raise NotImplementedError(f"EAP map estimate (map_estimate & 2) is "
                                  f"{later}")
    if cfg.saveAllMaps or args.mat_export:
        raise NotImplementedError(f".mat export is {later}")
    if cfg.savePrediction:
        raise NotImplementedError(f"save_prediction (.mat) is {later}")
    if args.truth:
        raise NotImplementedError(f"--truth (in-loop OSPA) is {later}")
    if args.islands:
        raise NotImplementedError(
            "--islands is ROADMAP Queue 1 item 14 (sharding)")
    if args.resume or args.checkpoint_every:
        raise NotImplementedError(
            "checkpoint / resume is ROADMAP Queue 1 item 13")


def _step_inputs(sched, controls, rb, labels, valid, cfg, device):
    """Host schedule -> per-step (control, Measurements, dt, do_predict)."""
    m = cfg.maxMeasurements
    out = []
    for t, s in enumerate(sched):
        if s["z"] is not None:
            z = Measurements.from_numpy(rb[s["z"]], labels[s["z"]],
                                        valid[s["z"]], device)
        else:
            z = Measurements.empty(m, device)
        c = s["c"]
        ctrl = ((float(controls[c, 0]), float(controls[c, 1]))
                if c is not None and c >= 0 else (0.0, 0.0))
        dt = float(np.float32(s["dt"] if s["dt"] is not None else cfg.dt))
        out.append((ctrl, z, dt, t > 0 and s["predict"]))
    return out


def unpack_cov_channels(ch):
    """[10, F] channels in the S4 order -> [F, 4, 4] symmetric."""
    cov = np.zeros((ch.shape[-1], 4, 4), ch.dtype)
    k = 0
    for i in range(4):
        for j in range(i, 4):
            cov[:, i, j] = cov[:, j, i] = ch[k]
            k += 1
    return cov


def _write_log(out_dir, t, exp_pose, la, repeat, cfg):
    """One state_estimate log from host copies of a LogAux: the MAP
    particle's static map on line 2 and, under the dynamic and mixed
    feature models, its dynamic map on line 3."""
    w = la["map_w"]
    sel = w > 0
    mean = np.stack([la["map_mx"][sel], la["map_my"][sel]], axis=-1)
    cov = np.zeros((int(sel.sum()), 2, 2), np.float32)
    cov[:, 0, 0] = la["map_c00"][sel]
    cov[:, 0, 1] = cov[:, 1, 0] = la["map_c01"][sel]
    cov[:, 1, 1] = la["map_c11"][sel]
    dyn_w = dyn_mean = dyn_cov = None
    if cfg.featureModel != 0 and la["dyn_w"].shape[-1] > 0:
        dsel = la["dyn_w"] > 0
        dyn_w = la["dyn_w"][dsel]
        dyn_mean = la["dyn_mean"].T[dsel]
        dyn_cov = unpack_cov_channels(la["dyn_cov"])[dsel]
    is_cphd = cfg.filterType == CPHD_TYPE
    logs.write_state_estimate_log(
        out_dir, t, exp_pose, w[sel], mean, cov, dynamic_w=dyn_w,
        dynamic_mean=dyn_mean, dynamic_cov=dyn_cov,
        particle_log_weights=la["log_weights"],
        particle_poses=la["poses"], resample_idx=la["resample_idx"],
        cardinality=la["cardinality"] if is_cphd else None,
        max_cardinality=cfg.maxCardinality, is_cphd=is_cphd, repeat=repeat)


def _host(la) -> dict:
    return {k: v.cpu().numpy() for k, v in la._asdict().items()}


def run_synth(cfg, args) -> dict:
    check_run_supported(cfg, args)
    device = torch.device(args.device)
    data_dir = args.data_dir or cfg.dataDirectory
    meas_path = args.measurements or os.path.join(data_dir,
                                                  "measurements.txt")
    ctrl_path = args.controls or os.path.join(data_dir, "controls.txt")
    meas_sets = loaders.load_measurements(meas_path,
                                          labeled=cfg.labeledMeasurements)
    controls = loaders.load_controls(ctrl_path)
    meas_times = loaders.load_timestamps(
        os.path.join(data_dir, "measurement_times.txt"))
    ctrl_times = loaders.load_timestamps(
        os.path.join(data_dir, "control_times.txt"))

    traj = None
    if cfg.followTrajectory:
        # one particle driven along the given trajectory
        traj = loaders.load_trajectory(os.path.join(data_dir, "traj.txt"))
        cfg = cfg.replace(n_particles=1)

    n_steps = len(meas_sets)
    if meas_times is not None:
        n_steps = len(meas_times) + len(ctrl_times)
    if cfg.nSteps > 0:
        n_steps = min(n_steps, cfg.nSteps)
    n_steps = min(n_steps, cfg.maxSteps)

    rb, labels, valid = loaders.pad_measurement_sets(meas_sets,
                                                     cfg.maxMeasurements)
    out_dir = args.out_dir
    os.makedirs(out_dir, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = SlamState.create(cfg, device)
    sched = schedule_inputs(n_steps, meas_times, ctrl_times)
    steps = _step_inputs(sched, controls, rb, labels, valid, cfg, device)
    repeat0 = cfg.nPredictParticles

    if args.mode == "scan":
        if traj is not None:
            raise NotImplementedError(
                "follow_trajectory runs in loop mode only")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        final, (auxs, las) = run_scan(
            state, [s[0] for s in steps], [s[1] for s in steps],
            [s[2] for s in steps], cfg, generator=generator,
            with_log_state=True, with_variance=args.variance)
        poses = auxs.expected_pose.cpu().numpy()     # waits for the device
        elapsed = time.perf_counter() - t0
        t_len = len(steps)
        ms = elapsed / t_len * 1000
        neffs = auxs.neff.cpu().numpy()
        nan_steps = np.flatnonzero(~np.isfinite(neffs))
        t_valid = int(nan_steps[0]) if nan_steps.size else t_len
        if t_valid < t_len:
            print(f"nan weights detected at step {t_valid}! "
                  "truncating outputs...")
        aux_h = {k: v.cpu().numpy() for k, v in auxs._asdict().items()}
        la_h = _host(las)
        for t in range(t_valid):
            logs.append_loop_time(out_dir, ms)
            if args.no_logs:
                continue
            la_t = {k: v[t] for k, v in la_h.items()}
            _write_log(out_dir, t, poses[t], la_t,
                       repeat0 if t == 0 else 1, cfg)
            logs.append_metrics_jsonl(out_dir, dict(
                t=t, ms=ms, neff=float(aux_h["neff"][t]),
                n_measure=int(aux_h["n_measure"][t]),
                resampled=bool(aux_h["resampled"][t]),
                log_lik=float(aux_h["log_lik"][t]),
                card=float(la_t["map_w"].sum())))
        print(f"scan: {t_len} steps in {elapsed:.3f}s ({ms:.2f} ms/step)")
        return dict(state=final, poses=poses, aux=auxs, ms_per_step=ms,
                    nan_step=t_valid if t_valid < t_len else None)

    poses_out = []
    z_prev = None
    for t, (ctrl, z, dt, do_predict) in enumerate(steps):
        t0 = time.perf_counter()
        if traj is not None and t < len(traj):
            state = state.replace(pose=torch.as_tensor(
                traj[t], device=device).expand_as(state.pose).clone())
            do_predict = False
        state, aux = slam_step(state, ctrl, z, dt, do_predict, cfg,
                               generator=generator,
                               with_variance=args.variance, z_prev=z_prev)
        z_prev = z
        neff_val = float(aux.neff)                   # waits for the device
        elapsed_ms = (time.perf_counter() - t0) * 1000
        logs.append_loop_time(out_dir, elapsed_ms)
        exp_pose = aux.expected_pose.cpu().numpy()
        la = _host(log_aux(state))
        if not args.no_logs:
            _write_log(out_dir, t, exp_pose, la, repeat0 if t == 0 else 1,
                       cfg)
        logs.append_metrics_jsonl(out_dir, dict(
            t=t, ms=elapsed_ms, neff=neff_val, n_measure=z.count,
            resampled=bool(aux.resampled), log_lik=float(aux.log_lik),
            card=float(la["map_w"].sum())))
        poses_out.append(exp_pose)
        if np.isnan(neff_val):
            print("nan weights detected! exiting...")
            break
        if args.verbose:
            print(f"step {t}/{len(steps)} ms={elapsed_ms:.1f} "
                  f"neff={neff_val:.3f}")
    return dict(state=state, poses=np.asarray(poses_out))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("run_type", nargs="?", default="synth",
                    choices=["synth", "disparity"])
    ap.add_argument("profile", nargs="?", default="",
                    help="'profile' replays the step-100 fixture (not "
                         "ported yet)")
    ap.add_argument("--mode", default="loop", choices=["loop", "scan"])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--measurements", default=None)
    ap.add_argument("--controls", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-logs", action="store_true")
    ap.add_argument("--variance", action="store_true",
                    help="compute the per-particle cardinality variance")
    ap.add_argument("--verbose", action="store_true")
    # surfaces of phdslam_tpu.runner the port does not have yet
    ap.add_argument("--truth", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--islands", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--resume", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mat-export", action="store_true",
                    help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: CUDA is not available; pass --device "
            "cpu to run the kernels' plain versions on the CPU")
    if args.profile == "profile":
        raise NotImplementedError(
            "profile replay needs the step-100 checkpoint, ROADMAP Queue 1 "
            "item 13")
    cfg = load_config(args.config)
    if args.run_type == "disparity":
        return run_disparity(cfg, args)
    return run_synth(cfg, args)


if __name__ == "__main__":
    main()

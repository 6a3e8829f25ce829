"""Command-line entry point of the static GM-PHD SLAM port.

    python -m phdslam_tpu_torch.runner <config.cfg> synth \\
        --measurements M.txt --controls C.txt --out-dir OUT \\
        [--mode loop|scan] [--device cuda|cpu] [--seed N]

Mirrors ``phdslam_tpu/runner.py::run_synth``: timestamp-interleaved input
scheduling when ``*_times.txt`` files exist and lockstep otherwise,
prediction skipped at step 0, the update only on steps with measurements,
and the same ``state_estimateXXXXX.log``, ``loopTime.log`` and
``metrics.jsonl`` files, written by the shared ``io/logs.py``.

``--mode loop`` steps in a Python loop and writes the logs after every step;
``--mode scan`` queues the whole run on the device, then writes the logs
from the stacked per-step outputs. The map in the log is the MAP particle's.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from phdslam_tpu_torch import _shared
from phdslam_tpu_torch.filter.state import Measurements, SlamState
from phdslam_tpu_torch.filter.step import (check_supported, log_aux,
                                           run_scan, slam_step)


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


def _write_log(out_dir, t, exp_pose, la, repeat, cfg):
    """One state_estimate log from host copies of a LogAux."""
    w = la["map_w"]
    sel = w > 0
    mean = np.stack([la["map_mx"][sel], la["map_my"][sel]], axis=-1)
    cov = np.zeros((int(sel.sum()), 2, 2), np.float32)
    cov[:, 0, 0] = la["map_c00"][sel]
    cov[:, 0, 1] = cov[:, 1, 0] = la["map_c01"][sel]
    cov[:, 1, 1] = la["map_c11"][sel]
    _shared.write_state_estimate_log(
        out_dir, t, exp_pose, w[sel], mean, cov,
        particle_log_weights=la["log_weights"],
        particle_poses=la["poses"], resample_idx=la["resample_idx"],
        max_cardinality=cfg.maxCardinality, repeat=repeat)


def _host(la) -> dict:
    return {k: v.cpu().numpy() for k, v in la._asdict().items()}


def run_synth(cfg, args) -> dict:
    check_run_supported(cfg, args)
    device = torch.device(args.device)
    data_dir = args.data_dir or cfg.dataDirectory
    meas_path = args.measurements or os.path.join(data_dir,
                                                  "measurements.txt")
    ctrl_path = args.controls or os.path.join(data_dir, "controls.txt")
    meas_sets = _shared.load_measurements(meas_path,
                                          labeled=cfg.labeledMeasurements)
    controls = _shared.load_controls(ctrl_path)
    meas_times = _shared.load_timestamps(
        os.path.join(data_dir, "measurement_times.txt"))
    ctrl_times = _shared.load_timestamps(
        os.path.join(data_dir, "control_times.txt"))

    traj = None
    if cfg.followTrajectory:
        # one particle driven along the given trajectory
        traj = _shared.load_trajectory(os.path.join(data_dir, "traj.txt"))
        cfg = cfg.replace(n_particles=1)

    n_steps = len(meas_sets)
    if meas_times is not None:
        n_steps = len(meas_times) + len(ctrl_times)
    if cfg.nSteps > 0:
        n_steps = min(n_steps, cfg.nSteps)
    n_steps = min(n_steps, cfg.maxSteps)

    rb, labels, valid = _shared.pad_measurement_sets(meas_sets,
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
            _shared.append_loop_time(out_dir, ms)
            if args.no_logs:
                continue
            la_t = {k: v[t] for k, v in la_h.items()}
            _write_log(out_dir, t, poses[t], la_t,
                       repeat0 if t == 0 else 1, cfg)
            _shared.append_metrics_jsonl(out_dir, dict(
                t=t, ms=ms, neff=float(aux_h["neff"][t]),
                n_measure=int(aux_h["n_measure"][t]),
                resampled=bool(aux_h["resampled"][t]),
                log_lik=float(aux_h["log_lik"][t]),
                card=float(la_t["map_w"].sum())))
        print(f"scan: {t_len} steps in {elapsed:.3f}s ({ms:.2f} ms/step)")
        return dict(state=final, poses=poses, aux=auxs, ms_per_step=ms,
                    nan_step=t_valid if t_valid < t_len else None)

    poses_out = []
    for t, (ctrl, z, dt, do_predict) in enumerate(steps):
        t0 = time.perf_counter()
        if traj is not None and t < len(traj):
            state = state.replace(pose=torch.as_tensor(
                traj[t], device=device).expand_as(state.pose).clone())
            do_predict = False
        state, aux = slam_step(state, ctrl, z, dt, do_predict, cfg,
                               generator=generator,
                               with_variance=args.variance)
        neff_val = float(aux.neff)                   # waits for the device
        elapsed_ms = (time.perf_counter() - t0) * 1000
        _shared.append_loop_time(out_dir, elapsed_ms)
        exp_pose = aux.expected_pose.cpu().numpy()
        la = _host(log_aux(state))
        if not args.no_logs:
            _write_log(out_dir, t, exp_pose, la, repeat0 if t == 0 else 1,
                       cfg)
        _shared.append_metrics_jsonl(out_dir, dict(
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda when available)")
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
    if args.device is None:
        args.device = "cuda" if torch.cuda.is_available() else "cpu"
    if args.run_type == "disparity":
        raise NotImplementedError(
            "the disparity pipeline is ROADMAP Queue 1 item 12")
    if args.profile == "profile":
        raise NotImplementedError(
            "profile replay needs the step-100 checkpoint, ROADMAP Queue 1 "
            "item 13")
    cfg = _shared.load_config(args.config)
    return run_synth(cfg, args)


if __name__ == "__main__":
    main()

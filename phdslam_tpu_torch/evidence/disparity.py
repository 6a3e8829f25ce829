"""Disparity (monocular SC-PHD) evidence on the port
(``scripts/disparity_evidence.py``).

    python3 -m phdslam_tpu_torch.evidence.disparity [--oracle] [--quick]
        [--device cuda|cpu] [--plot] [--cpu-steps N]

main: the shipped scenario (make_disparity_scenario(rng(7), 30 landmarks,
100 steps)) re-noised 10 times (run r: default_rng(100 + r)), each run one
run_disparity_scan with the map log (the generator seeded r, the initial
roll and yaw jittered by +-0.03 rad from it): per step the camera position
error, every 2nd step the OSPA(p = 1, c = 1) of the MAP particle's 3-D
feature means (its round(sum w) heaviest) against the landmarks, and its
map mass -> "disparity". --quick: 2 runs x 30 steps.

--oracle: the NumPy CPU reference (reference_cpu_disparity.run, 16
particles, seed 1) against one port run (seed 1) on the shipped
data/disparity_synth/ stream -> "disparity_cpu_oracle"; the CPU leg runs
first, in this process, as in the script. --smoke: 8 particles x 16 slots
x 8 points, 2 runs x 6 steps, nothing written."""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from phdslam_tpu_torch.evidence import common as C

STRIDE = 2
SMOKE_WIDTHS = dict(n_particles=8, maxFeatures=16, particlesPerFeature=8)


def disparity_cfg(smoke=False):
    cfg = C.load_cfg("cfg/disparity_synth.cfg")
    return cfg.replace(**SMOKE_WIDTHS) if smoke else cfg


# ---------------------------------------------------------- statistics --

def score_run(poses, map_w, map_mean, traj, landmarks, t_len,
              stride=STRIDE):
    """One run's (camera position error [T], OSPA [T] (NaN off the
    stride), map mass [T])."""
    from phdslam_tpu_torch.ops.ospa import ospa_np
    pose_err = np.linalg.norm(poses[:t_len, :3] - traj[:t_len, :3], axis=1)
    card = map_w.sum(-1)[:t_len]
    ospa = np.full(t_len, np.nan)
    for t in range(0, t_len, stride):
        w = map_w[t]
        n_est = int(round(float(w.sum())))
        sel = np.argsort(-w)[: max(n_est, 0)]
        ospa[t] = ospa_np(landmarks, map_mean[t][sel], p=1.0, c=1.0)[0]
    return pose_err, ospa, card


def disparity_entry(pose_err, ospa, card_est, ms_per_step, t_len,
                    n_landmarks, stride=STRIDE) -> dict:
    """pose_err, ospa, card_est [R, T]; ms_per_step a run."""
    n_runs = pose_err.shape[0]
    return dict(
        n_runs=n_runs, steps=t_len,
        pose_mean=round(float(pose_err.mean()), 3),
        pose_final_mean=round(float(pose_err[:, -1].mean()), 3),
        pose_final_std=round(float(pose_err[:, -1].std()), 3),
        ospa_late_mean=round(float(np.nanmean(ospa[:, t_len // 2:])), 3),
        ospa_final_mean=round(float(np.nanmean(
            ospa[:, [t for t in range(0, t_len, stride)][-1]])), 3),
        card_final_mean=round(float(card_est[:, -1].mean()), 2),
        n_landmarks=int(n_landmarks),
        # run 0 pays the warm-up; the warm runs are the throughput number
        ms_per_step=round(float(np.mean(ms_per_step[1:])), 2)
        if len(ms_per_step) > 1 else round(float(ms_per_step[0]), 2),
        ms_per_step_cold=round(float(ms_per_step[0]), 2))


def oracle_entry(n_cpu, t_len, cpu, tpu_err, tpu_card_final,
                 cut=None) -> dict:
    """cpu: (camera errors, ms per step, the MAP particle's map mass a
    step) of the CPU reference."""
    cpu_err, cpu_ms, cards = cpu
    out = dict(
        n_particles_cpu=n_cpu, steps=t_len,
        cpu_ms_per_step=round(cpu_ms, 1),
        cpu_pose_mean=round(float(cpu_err.mean()), 3),
        cpu_pose_final=round(float(cpu_err[-1]), 3),
        cpu_card_final=round(float(cards[-1]), 2),
        tpu_pose_mean=round(float(tpu_err.mean()), 3),
        tpu_pose_final=round(float(tpu_err[-1]), 3),
        tpu_card_final=round(float(tpu_card_final), 2))
    if cut:
        out["cpu_steps"] = cut
    return out


# -------------------------------------------------------------- filter --

def sets_of(meas):
    from phdslam_tpu_torch.io.loaders import MeasurementSet
    out = []
    for z in meas:
        z = np.asarray(z, np.float32).reshape(-1, 2)
        out.append(MeasurementSet(ranges=z[:, 0], bearings=z[:, 1],
                                  labels=np.zeros(z.shape[0], np.int32)))
    return out


def run_scan(cfg, rb, valid, t_len, seed, dev):
    """One run_disparity_scan with the map log from the jittered start:
    (expected poses [T, 12], map_w [T, F], map means [T, F, 3]) on the
    host, and the run's seconds up to the poses' copy."""
    import torch

    from phdslam_tpu_torch.filter import disparity as D
    from phdslam_tpu_torch.filter.state import Measurements
    rb_d, valid_d = (torch.as_tensor(a[:t_len], device=dev)
                     for a in (rb, valid))
    labels = torch.zeros(valid_d.shape, dtype=torch.int32, device=dev)
    zs = [Measurements(rb=rb_d[t], label=labels[t], valid=valid_d[t],
                       count=int(valid[t].sum())) for t in range(t_len)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = D.DisparityState.create(cfg, dev)
    jitter = torch.rand((cfg.n_particles, 2), generator=gen,
                        device=dev) * 0.06 - 0.03
    pose = state.pose.clone()
    pose[:, 3] += jitter[:, 0]
    pose[:, 5] += jitter[:, 1]
    state = state.replace(pose=pose)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, (auxs, _plog, (map_w, map_mean, _mc)) = D.run_disparity_scan(
        state, zs, float(np.float32(cfg.dt)), cfg, generator=gen,
        with_map_log=True)
    poses = auxs.expected_pose.cpu().numpy()        # waits for the device
    elapsed = time.perf_counter() - t0
    return poses, map_w.cpu().numpy(), map_mean.cpu().numpy(), elapsed


def phase_main(opts, dev):
    from phdslam_tpu_torch.io.loaders import pad_measurement_sets
    from phdslam_tpu_torch.simdata import (generate_disparity_run,
                                           make_disparity_scenario)
    cfg = disparity_cfg(opts.smoke)
    sc = make_disparity_scenario(np.random.default_rng(7), n_landmarks=30,
                                 n_steps=100)
    t_len = 6 if opts.smoke else 30 if opts.quick else sc.traj.shape[0]
    n_runs = 2 if (opts.quick or opts.smoke) else 10
    if cfg.nSteps > 0:
        t_len = min(t_len, cfg.nSteps)
    pose_err = np.zeros((n_runs, t_len))
    ospa = np.full((n_runs, t_len), np.nan)
    card_est = np.zeros((n_runs, t_len))
    ms_per_step = []
    for run in range(n_runs):
        meas = generate_disparity_run(np.random.default_rng(100 + run), sc)
        rb, _, valid = pad_measurement_sets(sets_of(meas),
                                            cfg.maxMeasurements)
        poses, map_w, map_mean, elapsed = run_scan(cfg, rb, valid, t_len,
                                                   run, dev)
        ms_per_step.append(elapsed / t_len * 1000)
        pose_err[run], ospa[run], card_est[run] = score_run(
            poses, map_w, map_mean, sc.traj, sc.landmarks, t_len)
        print(f"run {run}: pose mean {pose_err[run].mean():.3f} m, "
              f"final {pose_err[run, -1]:.3f} m, final OSPA "
              f"{ospa[run][np.isfinite(ospa[run])][-1]:.3f}, "
              f"{ms_per_step[-1]:.1f} ms/step", flush=True)
    if opts.plot:
        with np.errstate(invalid="ignore"):
            agg = dict(pose_err_mean=pose_err.mean(0),
                       pose_err_std=pose_err.std(0),
                       ospa_mean=np.nanmean(ospa, 0),
                       ospa_std=np.nanstd(ospa, 0))
        C.plot([agg], "port_disparity_envelopes", ["port"], opts.out)
    return dict(disparity=disparity_entry(
        pose_err, ospa, card_est, ms_per_step, t_len,
        sc.landmarks.shape[0]))


def map_mass(particles) -> float:
    """The MAP particle's map mass."""
    return particles[int(np.argmax([p.log_weight for p in particles]))] \
        .w.sum()


def oracle_cpu_run(cfg_cpu, meas, truth, t_len):
    """The CPU disparity reference at seed 1: (camera errors, ms per step,
    map mass a step)."""
    from phdslam_tpu_torch import reference_cpu_disparity as RD
    cards = []
    t0 = time.perf_counter()
    poses = RD.run(cfg_cpu, meas[:t_len], seed=1,
                   callback=lambda t, ps: cards.append(map_mass(ps)))
    ms = (time.perf_counter() - t0) / t_len * 1000
    err = np.linalg.norm(poses[:, :3] - truth[:t_len, :3], axis=1)
    return err, ms, cards


def phase_oracle(opts, dev):
    from phdslam_tpu_torch.io.loaders import (load_measurements,
                                              pad_measurement_sets)
    cfg = disparity_cfg(opts.smoke)
    data = C.ROOT / "data" / "disparity_synth"
    sets = load_measurements(str(data / "measurements.txt"))
    truth = np.loadtxt(str(data / "traj.txt"), comments="%")
    t_len = 6 if opts.smoke else 30 if opts.quick else len(sets)
    t_cpu = C.cut(t_len, opts.cpu_steps)
    meas = [np.stack([s.ranges, s.bearings], 1) for s in sets[:t_len]]
    cfg_cpu = cfg.replace(n_particles=16)
    rb, _, valid = pad_measurement_sets(sets, cfg.maxMeasurements)
    cpu = oracle_cpu_run(cfg_cpu, meas, truth, t_cpu)
    poses, map_w, _, _ = run_scan(cfg, rb, valid, t_len, 1, dev)
    tpu_err = np.linalg.norm(poses[:, :3] - truth[:t_len, :3], axis=1)
    return dict(disparity_cpu_oracle=oracle_entry(
        cfg_cpu.n_particles, t_len, cpu, tpu_err, map_w[-1].sum(),
        t_cpu if t_cpu != t_len else None))


def main(argv=None) -> dict:
    ap = C.parser(__doc__.split("\n")[0], plot=True)
    ap.add_argument("--oracle", action="store_true",
                    help="the CPU reference against the port instead")
    C.add_cpu_leg_flags(ap)
    opts = ap.parse_args(argv)
    dev = C.resolve_device(opts.device)
    update = (phase_oracle if opts.oracle else phase_main)(opts, dev)
    fields = C.device_fields(dev)
    if opts.smoke:
        update = {k: dict(v, **fields) for k, v in update.items()}
        print(json.dumps(update))
        return update
    return C.merge_json(update, opts.out, fields)


if __name__ == "__main__":
    main(sys.argv[1:])

"""Mixed-model (static landmarks + moving targets) evidence on the port
(``scripts/mixed_evidence.py``).

    python3 -m phdslam_tpu_torch.evidence.mixed [--quick] [--smoke]
        [--informed] [--labeled] [--set key=value ...] [--skip-cpu]
        [--device cuda|cpu] [--plot] [--cpu-steps N]

Main leg: the loop-closure map (make_scenario(rng(11), 40 landmarks, 150
steps)) with three constant-velocity movers, 10 runs (run r re-noised by
generate_mixed_run(default_rng(500 + r)), its generator seeded r) through
run_scan with the log state at cfg/mixed_synth.cfg's defaults (256
particles x 128 slots x 64 measurements), measurements unlabeled unless
--labeled. Scores: the pose error a step; at every post-burn-in step with
a mover in the true FOV, the distance to the nearest dynamic feature of
the step's MAP particle and the velocity cosine; on the settled steps
(the 4th in-FOV step in a row on) also the distance at any weight, in the
MAP particle's own frame, and a known-association Kalman tracker's at the
true pose (the oracle). Paused-dwell leg: 5 runs of a 120-step scenario
in which the vehicle holds for 30 steps while one mover crosses its FOV,
scored over the post-lock-on window. CPU leg: the NumPy reference
(reference_cpu.run, 16 particles, seed 2) on run 0's stream over 60 steps,
after the GPU legs; skipped under --informed,
--labeled, --set or --skip-cpu, as in the script (their entries keep the
results file's earlier CPU numbers).

--informed sets birthVelocityInit, --labeled labeledMeasurements, --set
any config field (repeatable); the output key is the script's ("mixed",
"mixed_informed", then "_labeled" and "_<key><value>" a --set, sorted).
--quick: 2 runs x 40 steps (CPU leg 20 steps); --smoke: 32 particles x 32
slots x 16 measurements, 1 run x 12 steps, nothing written."""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from phdslam_tpu_torch.evidence import common as C

MOVER0 = np.array([[13.0, 9.0], [-9.0, 12.0], [10.0, -6.0]])
MOVER_V = np.array([[-0.22, -0.10], [0.20, -0.12], [-0.14, 0.18]])
# the paused-dwell leg's one mover, and its post-lock-on window
PAUSE_MOVER0 = np.array([[-5.51416556, -3.72010326]])
PAUSE_MOVER_V = np.array([[-0.15390214, 0.2575153]])
PAUSE_WINDOW = (68, 93)


def sizes(opts):
    """(T, runs, pause T, pause runs, CPU steps) of the script."""
    if opts.smoke:
        return 12, 1, 12, 1, 4
    return (40 if opts.quick else 150, 2 if opts.quick else 10, 120, 5,
            20 if opts.quick else 60)


def parse_overrides(items):
    out = {}
    for item in items or ():
        k, v = item.split("=")
        out[k] = float(v)
    return out


def out_key(informed, labeled, overrides) -> str:
    return (("mixed_informed" if informed else "mixed")
            + ("_labeled" if labeled else "")
            + "".join(f"_{k}{v:g}" for k, v in sorted(overrides.items())))


def mixed_config(sc, smoke, informed, labeled, overrides):
    """The shipped mixed defaults with run_batch's start pose, the shape
    overrides only (and --set's)."""
    cfg = C.start_pose(C.load_cfg("cfg/mixed_synth.cfg").replace(
        n_particles=32 if smoke else 256,
        maxFeatures=32 if smoke else 128,
        maxMeasurements=16 if smoke else 64,
        birthVelocityInit=informed, labeledMeasurements=labeled), sc.traj)
    if overrides:
        cfg = cfg.replace(**{k: type(getattr(cfg, k))(v)
                             for k, v in overrides.items()})
    return cfg


def padded(meas, z_labels, m, labeled):
    """(rb [T, M, 2], labels [T, M], valid [T, M]); labels 0 unless
    labeled."""
    t_len = len(meas)
    rb = np.zeros((t_len, m, 2), np.float32)
    valid = np.zeros((t_len, m), bool)
    lab = np.zeros((t_len, m), np.int32)
    for t in range(t_len):
        z = meas[t][:m]
        rb[t, :len(z)] = z
        valid[t, :len(z)] = True
        if labeled:
            lab[t, :len(z)] = z_labels[t][:m]
    return rb, lab, valid


# ---------------------------------------------------------- statistics --

def oracle_track(sc, cfg, meas, truth, t_len):
    """Per-mover 4-state CV Kalman with oracle association (nearest
    measurement to the TRUE position within a 3-sigma gate, world frame at
    the TRUE pose). Returns est [T, K, 2] (nan before the first
    detection)."""
    kn = truth.shape[1]
    est = np.full((t_len, kn, 2), np.nan)
    x = [None] * kn
    pm = [None] * kn
    dtv = sc.dt
    F = np.eye(4)
    F[0, 2] = F[1, 3] = dtv
    q = 1e-4          # movers are exactly CV; tiny for conditioning
    Q = np.diag([0.25 * q * dtv ** 4] * 2 + [q * dtv ** 2] * 2)
    H = np.zeros((2, 4))
    H[0, 0] = H[1, 1] = 1.0
    for t in range(t_len):
        vp = sc.traj[t]
        z = meas[t]
        if len(z):
            zw = np.stack(
                [vp[0] + z[:, 0] * np.cos(vp[2] + z[:, 1]),
                 vp[1] + z[:, 0] * np.sin(vp[2] + z[:, 1])], axis=1)
        for k in range(kn):
            if x[k] is not None:
                x[k] = F @ x[k]
                pm[k] = F @ pm[k] @ F.T + Q
            pos = truth[t, k]
            r_true = np.linalg.norm(pos - vp[:2])
            var_p = cfg.stdRange ** 2 + (r_true * cfg.stdBearing) ** 2
            if len(z):
                dd = np.linalg.norm(zw - pos, axis=1)
                j = int(np.argmin(dd))
                if dd[j] < 3.0 * np.sqrt(var_p):
                    R = var_p * np.eye(2)
                    if x[k] is None:
                        x[k] = np.array([zw[j, 0], zw[j, 1], 0., 0.])
                        pm[k] = np.diag([var_p, var_p, cfg.covVxBirth,
                                         cfg.covVyBirth])
                    else:
                        S = H @ pm[k] @ H.T + R
                        G = pm[k] @ H.T @ np.linalg.inv(S)
                        x[k] = x[k] + G @ (zw[j] - H @ x[k])
                        pm[k] = (np.eye(4) - G @ H) @ pm[k]
            if x[k] is not None:
                est[t, k] = x[k][:2]
    return est


def _in_fov(cfg, pos, vpose):
    d = pos - vpose[:2]
    r = np.linalg.norm(d)
    b = np.arctan2(d[1], d[0]) - vpose[2]
    b = np.arctan2(np.sin(b), np.cos(b))
    return cfg.minRange <= r <= cfg.maxRange and abs(b) <= cfg.maxBearing


def _selected(w4):
    """The feature-existence threshold: the strongest quarter, at least
    0.05 (a mover's unit mass spreads over a few components)."""
    return w4 >= max(0.05, 0.25 * float(w4.max()))


SCORES = ("mover_dist", "vel_cos", "settled_dist", "settled_cos",
          "settled_dist_rel", "settled_dist_any", "settled_nearest_w",
          "oracle_settled")


def score_run(cfg, sc, truth, la, oracle_est, t_len, scores):
    """Append one run's scores (the main leg) to the lists in ``scores``
    (SCORES -> list), from its log state on the host (dyn_w [T, Fd],
    dyn_mean [T, 4, Fd], log_weights [T, P], poses [T, P, 6])."""
    dyn_w_all = np.asarray(la.dyn_w)
    dyn_m_all = np.asarray(la.dyn_mean)
    lw_all = np.asarray(la.log_weights)
    poses_all = np.asarray(la.poses)
    map_pose = poses_all[np.arange(t_len), lw_all.argmax(axis=1)]
    burn = max(10, t_len // 5)
    kn = MOVER0.shape[0]
    # consecutive in-FOV steps per mover, seeded over the pre-burn window
    # so that a dwell across the burn boundary counts its whole length
    streak = np.zeros(kn, int)
    for t in range(burn):
        for k in range(kn):
            streak[k] = streak[k] + 1 if _in_fov(cfg, truth[t, k],
                                                 sc.traj[t]) else 0
    s = scores
    for t in range(burn, t_len):
        w4 = dyn_w_all[t]
        m4 = dyn_m_all[t].T                       # [Fd, 4] = x, y, vx, vy
        sel = _selected(w4)
        vpose = sc.traj[t]
        for k in range(kn):
            pos = truth[t, k]
            if not _in_fov(cfg, pos, vpose):
                streak[k] = 0
                continue
            streak[k] += 1
            settled = streak[k] >= 4
            if settled:
                oe = oracle_est[t, k]
                s["oracle_settled"].append(
                    float(np.linalg.norm(oe - pos))
                    if np.isfinite(oe).all() else np.inf)
            if not sel.any():
                s["mover_dist"].append(np.inf)
                if settled:
                    s["settled_dist"].append(np.inf)
                continue
            dd = np.linalg.norm(m4[sel][:, :2] - pos, axis=1)
            j = int(np.argmin(dd))
            s["mover_dist"].append(float(dd[j]))
            v_est = m4[sel][j, 2:]
            nv = np.linalg.norm(v_est) * np.linalg.norm(MOVER_V[k])
            cos = float(v_est @ MOVER_V[k] / nv) if nv > 0 else None
            if cos is not None:
                s["vel_cos"].append(cos)
            if not settled:
                continue
            s["settled_dist"].append(float(dd[j]))
            any_sel = w4 > 0.01
            if any_sel.any():
                da = np.linalg.norm(m4[any_sel][:, :2] - pos, axis=1)
                ja = int(np.argmin(da))
                s["settled_dist_any"].append(float(da[ja]))
                s["settled_nearest_w"].append(float(w4[any_sel][ja]))
            else:
                s["settled_dist_any"].append(np.inf)
            # the distance in the MAP particle's own frame: the mixed
            # subsystem's quality with the SLAM pose error taken out
            pe = map_pose[t]
            ce, se = np.cos(-pe[2]), np.sin(-pe[2])
            re_ = m4[sel][j, :2] - pe[:2]
            rel_e = np.array([ce * re_[0] - se * re_[1],
                              se * re_[0] + ce * re_[1]])
            ct_, st_ = np.cos(-vpose[2]), np.sin(-vpose[2])
            rt_ = pos - vpose[:2]
            rel_t = np.array([ct_ * rt_[0] - st_ * rt_[1],
                              st_ * rt_[0] + ct_ * rt_[1]])
            s["settled_dist_rel"].append(float(np.linalg.norm(rel_e - rel_t)))
            if cos is not None:
                s["settled_cos"].append(cos)


def pause_scores(la, truth, lo, hi, t_len, p_dist, p_cos):
    """Append a paused-dwell run's distances and cosines over [lo, hi)."""
    dyn_w_all = np.asarray(la.dyn_w)
    dyn_m_all = np.asarray(la.dyn_mean)
    for t in range(lo, min(hi, t_len)):
        w4 = dyn_w_all[t]
        m4 = dyn_m_all[t].T
        sel = _selected(w4)
        if not sel.any():
            p_dist.append(np.inf)
            continue
        pos = truth[t, 0]
        dd = np.linalg.norm(m4[sel][:, :2] - pos, axis=1)
        j = int(np.argmin(dd))
        p_dist.append(float(dd[j]))
        v_est = m4[sel][j, 2:]
        nv = np.linalg.norm(v_est) * np.linalg.norm(PAUSE_MOVER_V[0])
        if nv > 0:
            p_cos.append(float(v_est @ PAUSE_MOVER_V[0] / nv))


def paused_entry(p_dist, p_cos, n_runs) -> dict:
    pd_arr = np.asarray(p_dist)
    return dict(
        n_runs=n_runs, dwell_steps=int(pd_arr.size // max(n_runs, 1)),
        dist_mean=round(float(pd_arr[np.isfinite(pd_arr)].mean()), 3)
        if np.isfinite(pd_arr).any() else None,
        dist_under_2m=round(float((pd_arr < 2.0).mean()), 3)
        if pd_arr.size else None,
        cos_mean=round(float(np.mean(p_cos)), 3) if p_cos else None)


def _mean(values, finite=False):
    """The rounded mean (of the finite values), None without any."""
    v = [x for x in values if np.isfinite(x)] if finite else list(values)
    return round(float(np.mean(v)), 3) if v else None


def _under_2m(values):
    return round(float(np.mean([d < 2.0 for d in values])), 3) \
        if len(values) else None


def mixed_entry(informed, overrides, n_particles, pose_err, ms_per_step,
                scores, paused, dyn_mass, cpu_n_particles, tc, cpu,
                cut=None) -> dict:
    """pose_err [R, T]; scores: SCORES -> list; paused: paused_entry;
    cpu: (ms per step, pose errors [Tc]) or None when the leg was
    skipped."""
    s = scores
    md = np.asarray(s["mover_dist"])
    n_runs, t_len = pose_err.shape
    out = dict(
        birth_velocity_init=informed, overrides=overrides,
        n_runs=n_runs, steps=t_len, n_particles=n_particles,
        pose_mean=round(float(pose_err.mean()), 3),
        pose_late_mean=round(float(pose_err[:, t_len // 2:].mean()), 3),
        # run 0 pays the warm-up; the warm runs are the throughput number
        ms_per_step=round(float(np.mean(ms_per_step[1:])), 2)
        if len(ms_per_step) > 1 else round(float(ms_per_step[0]), 2),
        ms_per_step_cold=round(float(ms_per_step[0]), 2),
        movers_scored=int(md.size),
        mover_dist_mean=round(float(md[np.isfinite(md)].mean()), 3)
        if np.isfinite(md).any() else None,
        mover_dist_under_2m=round(float((md < 2.0).mean()), 3)
        if md.size else None,
        vel_cos_mean=_mean(s["vel_cos"]),
        settled_scored=int(len(s["settled_dist"])),
        settled_dist_mean=_mean(s["settled_dist"], finite=True),
        settled_dist_under_2m=_under_2m(s["settled_dist"]),
        settled_cos_mean=_mean(s["settled_cos"]),
        settled_dist_any_mean=_mean(s["settled_dist_any"], finite=True),
        settled_dist_any_under_2m=_under_2m(s["settled_dist_any"]),
        settled_nearest_w_mean=_mean(s["settled_nearest_w"]),
        settled_dist_rel_mean=_mean(s["settled_dist_rel"], finite=True),
        settled_dist_rel_under_2m=_under_2m(s["settled_dist_rel"]),
        oracle_settled_dist_mean=_mean(s["oracle_settled"], finite=True),
        oracle_settled_under_2m=_under_2m(s["oracle_settled"]),
        paused_dwell=paused,
        dyn_mass_mean=round(float(np.mean(dyn_mass)), 2),
        cpu_n_particles=cpu_n_particles, cpu_steps=tc,
        cpu_ms_per_step=None if cpu is None else round(cpu[0], 1),
        cpu_pose_mean=None if cpu is None
        else round(float(cpu[1].mean()), 3),
        tpu_pose_mean_cpu_window=round(float(pose_err[0, :tc].mean()), 3))
    if cut:
        out["cpu_cut_from_steps"] = cut
    return out


# -------------------------------------------------------------- filter --

def cpu_leg(cfg_cpu, sc, tc):
    """The CPU reference on run 0's stream: (ms per step, pose errors
    [tc])."""
    from phdslam_tpu_torch import reference_cpu as R
    from phdslam_tpu_torch.simdata import generate_mixed_run
    controls, meas, _ = generate_mixed_run(
        np.random.default_rng(500), sc, MOVER0, MOVER_V,
        control_noise=C.CONTROL_NOISE)
    t0 = time.perf_counter()
    poses = R.run(cfg_cpu, controls[:tc - 1], meas[:tc], seed=2)
    ms = (time.perf_counter() - t0) / tc * 1000
    return ms, C.pose_errors(poses, sc.traj)


def keep_cpu_numbers(prev: dict, entry: dict) -> dict:
    """The new entry, with the earlier entry's CPU numbers where this run
    skipped the CPU leg."""
    entry = dict(entry)
    for ck in ("cpu_ms_per_step", "cpu_pose_mean"):
        if entry.get(ck) is None and prev.get(ck) is not None:
            entry[ck] = prev[ck]
    return entry


def run_one(cfg, controls, rb, lab, valid, seed, dev):
    """One run through run_scan with the log state: (final state, stacked
    StepAux, LogAux on the host, seconds up to the poses' copy)."""
    import torch

    from phdslam_tpu_torch.filter import step
    from phdslam_tpu_torch.filter.state import Measurements, SlamState
    t_len = rb.shape[0]
    rb_d, lab_d, valid_d = (torch.as_tensor(a, device=dev)
                            for a in (rb, lab, valid))
    zs = [Measurements(rb=rb_d[t], label=lab_d[t], valid=valid_d[t],
                       count=int(valid[t].sum())) for t in range(t_len)]
    ctrl = np.concatenate([np.zeros((1, 2), np.float32),
                           controls[:t_len - 1]])
    dts = np.full((t_len,), cfg.dt, np.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = SlamState.create(cfg, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    final, (auxs, la) = step.run_scan(state, ctrl, zs, dts, cfg,
                                      generator=gen, with_log_state=True)
    poses = auxs.expected_pose.cpu().numpy()        # waits for the device
    elapsed = time.perf_counter() - t0
    la = type(la)(*(x.cpu().numpy() for x in la))   # one copy a run
    return final, poses, la, elapsed


def main(argv=None) -> dict:
    import torch

    from phdslam_tpu_torch.simdata import generate_mixed_run, make_scenario
    ap = C.parser(__doc__.split("\n")[0], plot=True)
    ap.add_argument("--informed", action="store_true",
                    help="birthVelocityInit (two-detection velocity init)")
    ap.add_argument("--labeled", action="store_true",
                    help="labeled measurements (label-gated update)")
    ap.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="a config override, repeatable")
    ap.add_argument("--skip-cpu", action="store_true",
                    help="skip the CPU reference leg")
    C.add_cpu_leg_flags(ap)
    opts = ap.parse_args(argv)
    dev = C.resolve_device(opts.device)
    overrides = parse_overrides(opts.set)
    t_len, n_runs, tp, n_pause_runs, tc_full = sizes(opts)
    tc = C.cut(tc_full, opts.cpu_steps)
    sc = make_scenario(np.random.default_rng(11), n_landmarks=40,
                       n_steps=t_len)
    cfg = mixed_config(sc, opts.smoke, opts.informed, opts.labeled,
                       overrides)
    key = out_key(opts.informed, opts.labeled, overrides)
    cfg_cpu = cfg.replace(n_particles=16)
    skip_cpu = bool(opts.informed or overrides or opts.skip_cpu
                    or opts.labeled)

    pose_err = np.zeros((n_runs, t_len))
    scores = {k: [] for k in SCORES}
    dyn_mass = np.zeros(n_runs)
    ms_per_step = []
    for run in range(n_runs):
        controls, meas, truth, z_labels = generate_mixed_run(
            np.random.default_rng(500 + run), sc, MOVER0, MOVER_V,
            control_noise=C.CONTROL_NOISE, return_labels=True)
        oracle_est = oracle_track(sc, cfg, meas, truth, t_len)
        rb, lab, valid = padded(meas[:t_len], z_labels,
                                cfg.maxMeasurements, opts.labeled)
        final, poses, la, elapsed = run_one(cfg, controls, rb, lab, valid,
                                            run, dev)
        ms_per_step.append(elapsed / t_len * 1000)
        pose_err[run] = C.pose_errors(poses, sc.traj)
        dyn_mass[run] = float(final.map_dynamic.w[
            int(torch.argmax(final.log_weights))].sum())
        scored_before = len(scores["mover_dist"])
        score_run(cfg, sc, truth, la, oracle_est, t_len, scores)
        print(f"run {run}: pose mean {pose_err[run].mean():.3f} m, "
              f"dyn mass {dyn_mass[run]:.2f}, step-movers scored "
              f"{len(scores['mover_dist']) - scored_before}", flush=True)

    # the paused-dwell leg: the vehicle holds while one mover crosses
    sc_p = make_scenario(np.random.default_rng(11), n_landmarks=40,
                         n_steps=tp, pause=(60, 30))
    p_dist, p_cos = [], []
    lo, hi = (8, tp) if opts.smoke else PAUSE_WINDOW
    for run in range(n_pause_runs):
        controls, meas, truth, z_labels = generate_mixed_run(
            np.random.default_rng(900 + run), sc_p, PAUSE_MOVER0,
            PAUSE_MOVER_V, control_noise=C.CONTROL_NOISE,
            return_labels=True)
        rb, lab, valid = padded(meas[:tp], z_labels, cfg.maxMeasurements,
                                opts.labeled)
        _, _, la, _ = run_one(cfg, controls, rb, lab, valid, 50 + run, dev)
        pause_scores(la, truth, lo, hi, tp, p_dist, p_cos)
    paused = paused_entry(p_dist, p_cos, n_pause_runs)
    print("paused-dwell leg:", json.dumps(paused), flush=True)
    cpu = None if skip_cpu else cpu_leg(cfg_cpu, sc, tc)

    if opts.plot:
        aggs = [dict(pose_err_mean=pose_err.mean(0),
                     pose_err_std=pose_err.std(0))]
        labels = [f"mixed port ({cfg.n_particles}p, {n_runs} runs)"]
        if cpu is not None:
            aggs.append(dict(pose_err_mean=cpu[1],
                             pose_err_std=np.zeros(tc)))
            labels.append(f"CPU reference ({cfg_cpu.n_particles}p, 1 run)")
        C.plot(aggs, "port_mixed_envelopes" + key[len("mixed"):], labels,
               opts.out)
    entry = mixed_entry(opts.informed, overrides, cfg.n_particles, pose_err,
                        ms_per_step, scores, paused, dyn_mass,
                        cfg_cpu.n_particles, tc, cpu,
                        tc_full if tc != tc_full and cpu is not None
                        else None)
    fields = C.device_fields(dev)
    if opts.smoke:
        out = {key: dict(entry, **fields)}
        print(json.dumps(out))
        return out
    return C.merge_json({key: entry}, opts.out, fields,
                        merge=keep_cpu_numbers)

if __name__ == "__main__":
    main(sys.argv[1:])

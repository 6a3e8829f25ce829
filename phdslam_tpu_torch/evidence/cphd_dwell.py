"""The CPHD dwell criterion on the port (``scripts/cphd_dwell.py``): with
the vehicle holding still, the CPHD's E[n] must climb to the true in-FOV
landmark count.

    python3 -m phdslam_tpu_torch.evidence.cphd_dwell [--device cuda|cpu]
        [--smoke] [--plot]

The pause scenario (make_scenario(rng(5), 40 landmarks, 110 steps, the
vehicle still over steps 40-99), re-noised with generate_run(rng(17)),
through run_scan with the log state: CPHD, gated births, map estimate 2,
256 particles x 128 slots x 64 measurements, the generator seeded 0. Per
step, E[n] of the MAP particle's cardinality pmf, the MAP map's in-FOV
mass and the true in-FOV count; over the settled dwell window (steps
50-99) the mean |E[n] - n_fov| -> "cphd_dwell" (the script's keys).
--smoke: 16 particles x 16 slots x 16 measurements, nothing written."""

from __future__ import annotations

import sys

import numpy as np

from phdslam_tpu_torch.evidence import common as C

T, PAUSE = 110, (40, 60)


def wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def dwell_setup(smoke=False):
    """(cfg, scenario, controls [T-1, 2], measurement sets)."""
    from phdslam_tpu_torch.simdata import generate_run, make_scenario
    sc = make_scenario(np.random.default_rng(5), n_landmarks=40, n_steps=T,
                       pause=PAUSE)
    cfg = C.start_pose(C.load_cfg("cfg/ackerman_synth.cfg").replace(
        n_particles=256, maxFeatures=128, maxMeasurements=64,
        filterType=1, maxCardinality=127, gateBirths=True,
        gateThreshold=9.0, mapEstimate=2), sc.traj)
    if smoke:
        cfg = cfg.replace(**C.SMOKE_WIDTHS)
    controls, meas = generate_run(np.random.default_rng(17), sc,
                                  control_noise=C.CONTROL_NOISE)
    return cfg, sc, controls, meas


def dwell_entry(cfg, sc, la, t_len=T, pause=PAUSE) -> dict:
    """The script's statistics from the stacked log state (numpy
    cardinality [T, N+1], log_weights [T, P], poses [T, P, 6], map_w,
    map_mx, map_my [T, F])."""
    cn = np.asarray(la.cardinality)
    pmf = np.exp(cn - cn.max(axis=1, keepdims=True))
    pmf /= pmf.sum(axis=1, keepdims=True)
    e_n = (pmf * np.arange(pmf.shape[1])).sum(1)

    lw = np.asarray(la.log_weights)
    all_poses = np.asarray(la.poses)
    map_pose = all_poses[np.arange(t_len), lw.argmax(axis=1)]
    w = np.asarray(la.map_w)
    dx = np.asarray(la.map_mx) - map_pose[:, None, 0]
    dy = np.asarray(la.map_my) - map_pose[:, None, 1]
    r = np.hypot(dx, dy)
    b = wrap(np.arctan2(dy, dx) - map_pose[:, None, 2])
    in_r = ((r >= cfg.minRange) & (r <= cfg.maxRange)
            & (np.abs(b) <= cfg.maxBearing))
    mass_in = (w * in_r).sum(1)

    d = sc.landmarks[None, :, :] - sc.traj[:t_len, None, :2]
    rt = np.linalg.norm(d, axis=-1)
    bt = wrap(np.arctan2(d[..., 1], d[..., 0]) - sc.traj[:t_len, 2][:, None])
    fov = ((rt <= cfg.maxRange) & (rt >= cfg.minRange)
           & (np.abs(bt) <= cfg.maxBearing))
    n_fov = fov.sum(1).astype(float)

    lo, hi = pause[0] + 10, pause[0] + pause[1]   # settled dwell window
    err_dwell = np.abs(e_n[lo:hi] - n_fov[lo:hi]).mean()
    return dict(T=t_len, pause=list(pause), e_n=e_n.tolist(),
                n_fov=n_fov.tolist(), mass_in_fov=mass_in.tolist(),
                dwell_window=[lo, hi],
                dwell_err_mean=round(float(err_dwell), 3),
                dwell_e_n_mean=round(float(e_n[lo:hi].mean()), 2),
                dwell_n_fov=round(float(n_fov[lo:hi].mean()), 2))


def run_dwell(cfg, sc, controls, meas, dev):
    """run_scan over the run with the log state; the LogAux on the host."""
    import torch

    from phdslam_tpu_torch.filter import step
    from phdslam_tpu_torch.filter.state import Measurements, SlamState
    m = cfg.maxMeasurements
    rb = np.zeros((T, m, 2), np.float32)
    valid = np.zeros((T, m), bool)
    for t in range(T):
        z = meas[t][:m]
        rb[t, :len(z)] = z
        valid[t, :len(z)] = True
    zs = [Measurements.from_numpy(rb[t], np.zeros(m, np.int32), valid[t],
                                  dev) for t in range(T)]
    ctrl = np.concatenate([np.zeros((1, 2), np.float32), controls[:T - 1]])
    dts = np.full((T,), cfg.dt, np.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    _, (_, la) = step.run_scan(SlamState.create(cfg, dev), ctrl, zs, dts,
                               cfg, generator=gen, with_log_state=True)
    return type(la)(*(x.cpu().numpy() for x in la))


def main(argv=None) -> dict:
    ap = C.parser(__doc__.split("\n")[0], plot=True)
    opts = ap.parse_args(argv)
    dev = C.resolve_device(opts.device)
    cfg, sc, controls, meas = dwell_setup(opts.smoke)
    out = dwell_entry(cfg, sc, run_dwell(cfg, sc, controls, meas, dev))
    lo, hi = out["dwell_window"]
    print(f"dwell window {lo}..{hi}: E[n] mean {out['dwell_e_n_mean']} "
          f"vs n_fov {out['dwell_n_fov']}; |err| mean "
          f"{out['dwell_err_mean']}")
    for t in range(0, T, 5):
        print(f"  {t:3d} E[n]={out['e_n'][t]:6.2f} "
              f"nfov={out['n_fov'][t]:3.0f} "
              f"massIn={out['mass_in_fov'][t]:6.2f}")
    if opts.plot:
        C.plot([dict(card_err_mean=np.abs(np.subtract(out["e_n"],
                                                       out["n_fov"])),
                     card_err_std=np.zeros(T))],
               "port_cphd_dwell", ["|E[n] - n_fov|"], opts.out)
    fields = C.device_fields(dev)
    if opts.smoke:
        return dict(cphd_dwell=dict(out, **fields))
    return C.merge_json(dict(cphd_dwell=out), opts.out, fields)


if __name__ == "__main__":
    main(sys.argv[1:])

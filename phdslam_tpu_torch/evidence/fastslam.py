"""The FastSLAM-against-PHD robustness grid on the port: the cells of
``scripts/fastslam_evidence.py`` through ``filter/step.py::slam_step``.

    python3 -m phdslam_tpu_torch.evidence.fastslam [--cell CLUTTER STD FTYPE]
        [--smoke] [--device cuda|cpu]

A cell is a (clutter_rate, std_range, filter_type) triple: 150 steps at
256 particles of make_scenario(rng(7), 80 landmarks) at that clutter and
range noise, re-noised with generate_run(rng(8)), the filter's generator
seeded 5; cfg/fastslam_synth.cfg for filter_type 2, else
cfg/ackerman_synth.cfg, started at the origin. The expected poses stay on
the device until the run ends. No --cell: the whole grid. Each row is
merged into the results file under "fastslam_grid" by its cell key
(c<clutter>_s<std>_f<type>); --smoke (20 steps, 32 particles) writes
nothing."""

from __future__ import annotations

import sys

import numpy as np

from phdslam_tpu_torch.evidence import common as C

# (clutter_rate, std_range, filter_type): FastSLAM across the regime, PHD
# anchors at the corners
GRID = [
    (2.0, 0.25, 2), (2.0, 1.0, 2), (20.0, 0.25, 2), (20.0, 1.0, 2),
    (2.0, 0.25, 0), (20.0, 1.0, 0),
]
STEPS, PARTICLES = 150, 256
SMOKE = dict(T=20, n_particles=32)


def cell_key(clutter, sr, ftype) -> str:
    return f"c{clutter:g}_s{sr:g}_f{ftype}"


def cell_config(clutter, sr, ftype, T=STEPS, n_particles=PARTICLES):
    cfg = C.load_cfg("cfg/fastslam_synth.cfg" if ftype == 2
                     else "cfg/ackerman_synth.cfg")
    return cfg.replace(clutterRate=clutter, stdRange=sr, nSteps=T,
                       n_particles=n_particles, x0=0.0, y0=0.0, yaw0=0.0)


def cell_data(cfg, clutter, sr, T=STEPS):
    """The cell's streams (scenario seed 7, run seed 8), the same for both
    filter types: (scenario, controls [T-1, 2], rb, labels, valid)."""
    import dataclasses

    from phdslam_tpu_torch.io.loaders import (MeasurementSet,
                                              pad_measurement_sets)
    from phdslam_tpu_torch.simdata import generate_run, make_scenario
    sc = make_scenario(np.random.default_rng(7), n_landmarks=80, n_steps=T,
                       clutter_rate=clutter)
    sc = dataclasses.replace(sc, std_range=sr)
    controls, meas = generate_run(np.random.default_rng(8), sc,
                                  control_noise=C.CONTROL_NOISE)
    sets = [MeasurementSet(z[:, 0], z[:, 1], np.zeros(len(z), np.int32))
            for z in meas]
    rb, labels, valid = pad_measurement_sets(sets, cfg.maxMeasurements)
    return sc, controls, rb, labels, valid


def cell_row(clutter, sr, ftype, T, n_particles, errs) -> dict:
    errs = np.asarray(errs)
    return {
        "clutter_rate": clutter, "std_range": sr, "filter_type": ftype,
        "steps": T, "n_particles": n_particles,
        "pose_mean": round(float(errs.mean()), 2),
        "pose_late_mean": round(float(errs[T // 2:].mean()), 2),
        "pose_max": round(float(errs.max()), 2),
    }


def run_cell(clutter, sr, ftype, T=STEPS, n_particles=PARTICLES,
             device="cuda") -> dict:
    """One cell through slam_step on ``device``; the grid's row."""
    import torch

    from phdslam_tpu_torch.filter import step
    from phdslam_tpu_torch.filter.state import Measurements, SlamState
    dev = torch.device(device)
    cfg = cell_config(clutter, sr, ftype, T, n_particles)
    sc, controls, rb, labels, valid = cell_data(cfg, clutter, sr, T)
    rb_d, lab_d, valid_d = (torch.as_tensor(a, device=dev)
                            for a in (rb, labels, valid))
    state = SlamState.create(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    dt = float(np.float32(cfg.dt))
    poses = []
    for t in range(T):
        z = Measurements(rb=rb_d[t], label=lab_d[t], valid=valid_d[t],
                         count=int(valid[t].sum()))
        u = ((float(controls[t - 1, 0]), float(controls[t - 1, 1]))
             if t > 0 else (0.0, 0.0))
        state, aux = step.slam_step(state, u, z, dt, t > 0, cfg,
                                    generator=gen)
        poses.append(aux.expected_pose)
    poses = torch.stack(poses).cpu().numpy()        # the one host copy
    return cell_row(clutter, sr, ftype, T, n_particles,
                    C.pose_errors(poses, sc.traj))


def main(argv=None) -> dict:
    """Run the grid or one --cell; returns cell key -> row."""
    ap = C.parser(__doc__.split("\n")[0])
    ap.add_argument("--cell", nargs=3, metavar=("CLUTTER", "STD", "FTYPE"),
                    help="one cell, e.g. --cell 2.0 0.25 2")
    opts = ap.parse_args(argv)
    dev = C.resolve_device(opts.device)
    fields = C.device_fields(dev)
    cells = GRID if opts.cell is None else [
        (float(opts.cell[0]), float(opts.cell[1]), int(opts.cell[2]))]
    rows = {}
    for clutter, sr, ftype in cells:
        row = dict(run_cell(clutter, sr, ftype, device=dev,
                            **(SMOKE if opts.smoke else {})), **fields)
        rows[cell_key(clutter, sr, ftype)] = row
        print(row, flush=True)
        if not opts.smoke:
            C.merge_json(
                dict(fastslam_grid={cell_key(clutter, sr, ftype): row}),
                opts.out, {}, merge=lambda grid, cell: dict(grid, **cell))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])

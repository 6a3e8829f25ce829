"""Synthetic data generation: trajectories, controls, and measurements.
A copy of ``phdslam_tpu/simdata.py``: the same seed gives the same arrays.

Rebuild of python/generate_simdata.py + python/AckermanMotionModel.py +
python/RangeBearingMeasurementModel.py (and the MATLAB SynthSetup2.m data
path): given a landmark map and a trajectory (or controls to roll one out),
produce noisy control and measurement files in the reference text formats.

Measurement generation semantics (python/RangeBearingMeasurementModel.py:33-55):
 - features within range/bearing FOV detected with probability pd
 - detections get Gaussian range/bearing noise (range may go negative for
   near-zero clutter/targets — the shipped datasets contain such values)
 - Poisson(clutterRate) clutter uniform in the FOV polar box
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Scenario:
    landmarks: np.ndarray          # [L, 2]
    traj: np.ndarray               # [T, 3] (x, y, theta)
    controls_true: np.ndarray      # [T-1, 2] (v_encoder, alpha)
    dt: float
    # sensor
    max_range: float = 10.0
    max_bearing: float = np.pi / 2
    std_range: float = 1.0
    std_bearing: float = 0.0349
    clutter_rate: float = 20.0
    pd: float = 0.95
    min_range: float = 0.0
    # vehicle (Victoria-Park Ackerman)
    l: float = 2.83
    h: float = 0.76
    a: float = 3.78
    b: float = 0.50


def ackerman_step_np(state, u, dt, l, h, a, b):
    x, y, th = state
    ve, al = u
    vc = ve / (1.0 - np.tan(al) * h / l)
    td = vc * np.tan(al) / l
    x2 = x + dt * (vc * np.cos(th) - td * (a * np.sin(th) + b * np.cos(th)))
    y2 = y + dt * (vc * np.sin(th) + td * (a * np.cos(th) - b * np.sin(th)))
    th2 = np.arctan2(np.sin(th + dt * td), np.cos(th + dt * td))
    return np.array([x2, y2, th2])


def make_scenario(rng: np.random.Generator, n_landmarks: int = 80,
                  n_steps: int = 330, dt: float = 1.0,
                  map_extent: float = 20.0, pause=None,
                  **sensor_kw) -> Scenario:
    """Random landmarks in a square + a wandering Ackerman trajectory
    (the SynthSetup2.m recipe: 80 landmarks in [-20,20]^2).

    pause: optional (t0, length) — the vehicle stops (v = 0) for `length`
    steps starting at t0, like a surveyed hold in a hand-driven course.
    Used by the mixed-model evidence to give a crossing mover a long
    uninterrupted FOV dwell (the wandering loop otherwise turns fast
    enough that no constant-velocity mover stays visible >6 steps)."""
    landmarks = rng.uniform(-map_extent, map_extent, (n_landmarks, 2))
    sc = Scenario(landmarks=landmarks,
                  traj=np.zeros((n_steps + 1, 3)),
                  controls_true=np.zeros((n_steps, 2)), dt=dt, **sensor_kw)
    state = np.zeros(3)
    traj = [state]
    controls = []
    v = 1.5
    for t in range(n_steps):
        # looping trajectory (radius ~ l/tan(alpha) = 11 m) with a gentle
        # serpentine: landmarks get revisited every lap, so SLAM drift is
        # bounded by loop closure — like the hand-driven closed courses of
        # matlab/generateAckermanTrajectory.m
        v = float(np.clip(v + rng.normal(0.0, 0.1), 1.0, 2.0))
        alpha = 0.24 + 0.05 * np.sin(t / 20.0) + rng.normal(0.0, 0.01)
        if pause is not None and pause[0] <= t < pause[0] + pause[1]:
            u = np.array([0.0, 0.0])
        else:
            u = np.array([v, alpha])
        state = ackerman_step_np(state, u, dt, sc.l, sc.h, sc.a, sc.b)
        controls.append(u)
        traj.append(state)
    sc.traj = np.asarray(traj)
    sc.controls_true = np.asarray(controls)
    return sc


def generate_measurements(rng: np.random.Generator, sc: Scenario,
                          pose) -> np.ndarray:
    """Measurements for one pose: [K, 2] (range, bearing)."""
    d = sc.landmarks - pose[:2]
    r = np.linalg.norm(d, axis=1)
    b = np.arctan2(d[:, 1], d[:, 0]) - pose[2]
    b = np.arctan2(np.sin(b), np.cos(b))
    fov = (r >= sc.min_range) & (r <= sc.max_range) \
        & (np.abs(b) <= sc.max_bearing)
    det = fov & (rng.uniform(size=r.shape) < sc.pd)
    zr = r[det] + rng.normal(0.0, sc.std_range, det.sum())
    zb = b[det] + rng.normal(0.0, sc.std_bearing, det.sum())
    n_clutter = rng.poisson(sc.clutter_rate)
    cr = rng.uniform(sc.min_range, sc.max_range, n_clutter)
    cb = rng.uniform(-sc.max_bearing, sc.max_bearing, n_clutter)
    z = np.stack([np.concatenate([zr, cr]), np.concatenate([zb, cb])],
                 axis=1)
    return z[rng.permutation(len(z))]


def generate_run(rng: np.random.Generator, sc: Scenario,
                 control_noise=(2.0, 0.0873)):
    """One Monte-Carlo run: noisy controls + per-step measurement sets.

    Returns (controls_noisy [T-1,2], list of [K,2] measurement arrays with
    one set per trajectory pose starting at t=0)."""
    t = sc.controls_true.shape[0]
    controls = sc.controls_true + rng.normal(
        0.0, control_noise, (t, 2))
    meas = [generate_measurements(rng, sc, sc.traj[k])
            for k in range(sc.traj.shape[0])]
    return controls.astype(np.float32), meas


def generate_mixed_run(rng: np.random.Generator, sc: Scenario,
                       mover0: np.ndarray, mover_v: np.ndarray,
                       control_noise=(2.0, 0.0873),
                       return_labels: bool = False):
    """Monte-Carlo run for the MIXED feature model: the static-landmark
    measurement stream of `generate_run` plus pd-thinned detections of
    constant-velocity moving targets (unlabeled — the filter has to sort
    static from dynamic itself, like the reference's unlabeled mixed mode,
    src/phdfilter.cu:2501-2503).

    mover0 [K, 2] initial positions; mover_v [K, 2] velocities.
    Returns (controls [T,2], measurement sets, mover truth [T+1, K, 2]);
    with return_labels, appends a list of per-step int label arrays
    (0 = static/clutter, 1 = mover detection) for the reference's LABELED
    mixed mode (label gating, src/phdfilter.cu:1913-1921,2501-2503)."""
    t_len = sc.controls_true.shape[0]
    controls = sc.controls_true + rng.normal(0.0, control_noise, (t_len, 2))
    meas = []
    labels = []
    truth = np.zeros((t_len + 1, mover0.shape[0], 2))
    for k in range(t_len + 1):
        pose = sc.traj[k]
        pos = mover0 + mover_v * (k * sc.dt)
        truth[k] = pos
        z = generate_measurements(rng, sc, pose)
        lab = np.zeros((len(z),), np.int32)
        d = pos - pose[:2]
        r = np.linalg.norm(d, axis=1)
        b = np.arctan2(d[:, 1], d[:, 0]) - pose[2]
        b = np.arctan2(np.sin(b), np.cos(b))
        fov = (r >= sc.min_range) & (r <= sc.max_range) \
            & (np.abs(b) <= sc.max_bearing)
        det = fov & (rng.uniform(size=r.shape) < sc.pd)
        if det.any():
            zm = np.stack(
                [r[det] + rng.normal(0.0, sc.std_range, det.sum()),
                 b[det] + rng.normal(0.0, sc.std_bearing, det.sum())],
                axis=1)
            perm = rng.permutation(len(z) + len(zm))
            z = np.concatenate([z, zm])[perm]
            lab = np.concatenate([lab, np.ones((len(zm),), np.int32)])[perm]
        meas.append(z)
        labels.append(lab)
    if return_labels:
        return controls.astype(np.float32), meas, truth, labels
    return controls.astype(np.float32), meas, truth


def write_run_files(directory: str, controls: np.ndarray, meas: List):
    """Write measurements.txt / controls.txt in the reference text format."""
    import os
    os.makedirs(directory, exist_ok=True)
    with open(f"{directory}/measurements.txt", "w") as f:
        f.write("% measurements from simulation data. One time step per "
                "line, each pair of of numbers is a range/bearing "
                "measurement.\n")
        for z in meas:
            f.write(" ".join(f"{v:.6f}" for v in z.reshape(-1)) + " \n")
    with open(f"{directory}/controls.txt", "w") as f:
        f.write("% velocity\tsteering angle\n")
        for u in controls:
            f.write(f"{u[0]:.6g} {u[1]:.6g}\n")


# ---------------------------------------------------------------------------
# Disparity (monocular SC-PHD) synthetic data
# ---------------------------------------------------------------------------

@dataclass
class DisparityScenario:
    """Ground truth for the disparity pipeline: a 6-DOF camera trajectory
    and static 3-D world landmarks, with the camera/sensor parameters of
    the reference's disparity block (cfg/config.cfg:83-97)."""

    landmarks: np.ndarray          # [L, 3] world points
    traj: np.ndarray               # [T, 12] pose + velocities
    dt: float = 1.0
    fx: float = -895.6561
    fy: float = -891.2656
    u0: float = 400.0
    v0: float = 300.0
    image_width: float = 800.0
    image_height: float = 600.0
    std_u: float = 5.0
    std_v: float = 5.0
    pd: float = 0.95
    clutter_rate: float = 5.0


def _camera_rotation_np(pose):
    """Rows of the camera->world rotation, the reference's expanded matrix
    (src/phdfilter.cu:3906-3914; mirrors models/camera._rotation_terms)."""
    roll, pitch, yaw = pose[3], pose[4], pose[5]
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.array([
        [cp * cy, cr * sy + sr * sp * cy, sr * sy - cr * sp * cy],
        [-cp * sy, cr * cy - sr * sp * sy, sr * cy + cr * sp * sy],
        [sp, -sr * cp, cr * cp]])


def project_to_image_np(points, pose, sc: DisparityScenario):
    """world -> (u, v) pixel projection + visibility mask (the numpy twin
    of models.camera.world_to_disparity)."""
    r = _camera_rotation_np(pose)
    pc = (points - pose[:3]) @ r          # world -> camera (R^T contract)
    zc = np.where(np.abs(pc[:, 2]) < 1e-12, 1e-12, pc[:, 2])
    u = sc.u0 - sc.fx * pc[:, 0] / zc
    v = sc.v0 - sc.fy * pc[:, 1] / zc
    d = -sc.fx / zc
    vis = ((u > 0) & (u < sc.image_width)
           & (v > 0) & (v < sc.image_height) & (d >= 0))
    return u, v, vis


def make_disparity_scenario(rng: np.random.Generator, n_landmarks: int = 30,
                            n_steps: int = 100, dt: float = 1.0,
                            **kw) -> DisparityScenario:
    """Camera starts at the origin looking along +z (the frustum of the
    reference's fx<0 convention), drifts with a small constant velocity;
    landmarks fill the frustum at depths 3-9 m."""
    sc = DisparityScenario(landmarks=np.zeros((n_landmarks, 3)),
                           traj=np.zeros((n_steps, 12)), dt=dt, **kw)
    depth = rng.uniform(3.0, 9.0, n_landmarks)
    # keep projections inside ~85% of the image over the whole trajectory
    tx = rng.uniform(-0.32, 0.32, n_landmarks)
    ty = rng.uniform(-0.24, 0.24, n_landmarks)
    sc.landmarks = np.stack([depth * tx, depth * ty, depth], axis=1)

    pose = np.zeros(12)
    pose[6] = 0.004    # vx (camera frame)
    pose[8] = 0.006    # vz: slow dolly-in
    pose[11] = 0.0006  # vyaw
    traj = []
    for _ in range(n_steps):
        traj.append(pose.copy())
        r = _camera_rotation_np(pose)
        dw = r @ (dt * pose[6:9])
        pose[:3] += dw
        pose[3:6] += dt * pose[9:12]
    sc.traj = np.asarray(traj)
    return sc


def generate_disparity_measurements(rng: np.random.Generator,
                                    sc: DisparityScenario,
                                    pose) -> np.ndarray:
    """(u, v) image measurements for one camera pose: pd-thinned detections
    with pixel noise + Poisson clutter uniform in the image."""
    u, v, vis = project_to_image_np(sc.landmarks, pose, sc)
    det = vis & (rng.uniform(size=vis.shape) < sc.pd)
    zu = u[det] + rng.normal(0.0, sc.std_u, det.sum())
    zv = v[det] + rng.normal(0.0, sc.std_v, det.sum())
    n_clutter = rng.poisson(sc.clutter_rate)
    cu = rng.uniform(0.0, sc.image_width, n_clutter)
    cv = rng.uniform(0.0, sc.image_height, n_clutter)
    z = np.stack([np.concatenate([zu, cu]), np.concatenate([zv, cv])],
                 axis=1)
    return z[rng.permutation(len(z))]


def generate_disparity_run(rng: np.random.Generator,
                           sc: DisparityScenario) -> List[np.ndarray]:
    return [generate_disparity_measurements(rng, sc, sc.traj[k])
            for k in range(sc.traj.shape[0])]


def write_disparity_files(directory: str, sc: DisparityScenario,
                          meas: List[np.ndarray]):
    """measurements.txt ((u, v) pairs per line, same container format as
    the range-bearing files), camera truth traj.txt (12 values per line)
    and landmarks.txt (x y z per line)."""
    import os
    os.makedirs(directory, exist_ok=True)
    with open(f"{directory}/measurements.txt", "w") as f:
        f.write("% disparity-pipeline measurements. One time step per "
                "line, each pair of numbers is a (u, v) pixel "
                "measurement.\n")
        for z in meas:
            f.write(" ".join(f"{x:.6f}" for x in z.reshape(-1)) + " \n")
    with open(f"{directory}/traj.txt", "w") as f:
        f.write("% camera ground truth: x y z roll pitch yaw vx vy vz "
                "vroll vpitch vyaw\n")
        for p in sc.traj:
            f.write(" ".join(f"{x:.8g}" for x in p) + "\n")
    with open(f"{directory}/landmarks.txt", "w") as f:
        f.write("% world landmarks: x y z\n")
        for p in sc.landmarks:
            f.write(" ".join(f"{x:.8g}" for x in p) + "\n")

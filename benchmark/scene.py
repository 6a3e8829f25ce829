"""The traffic generator: landmark scenes for a range-bearing SLAM filter.

A frozen copy of the port's ``simdata.py`` (``ackerman_step_np``,
``make_scenario`` without its pause, ``generate_measurements``), so that
the yardstick does not move when the program does: the same
``np.random.Generator`` gives the same arrays as the original. A traffic
mix is a JSON file of parameters (``benchmark/traffic/<name>.json``) that
``make_stream`` reads; no mix needs code of its own.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Scenario:
    landmarks: np.ndarray          # [L, 2]
    traj: np.ndarray               # [T + 1, 3] (x, y, theta)
    controls_true: np.ndarray      # [T, 2] (v_encoder, alpha)
    dt: float
    max_range: float = 10.0
    max_bearing: float = np.pi / 2
    std_range: float = 1.0
    std_bearing: float = 0.0349
    clutter_rate: float = 20.0
    pd: float = 0.95
    min_range: float = 0.0
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
                  map_extent: float = 20.0, **sensor_kw) -> Scenario:
    """Landmarks uniform in [-map_extent, map_extent]^2 and a looping
    Ackerman course (radius about 11 m, v in [1, 2] m/s, a gentle
    serpentine), so landmarks are revisited every lap."""
    landmarks = rng.uniform(-map_extent, map_extent, (n_landmarks, 2))
    sc = Scenario(landmarks=landmarks, traj=np.zeros((n_steps + 1, 3)),
                  controls_true=np.zeros((n_steps, 2)), dt=dt, **sensor_kw)
    state = np.zeros(3)
    traj = [state]
    controls = []
    v = 1.5
    for t in range(n_steps):
        v = float(np.clip(v + rng.normal(0.0, 0.1), 1.0, 2.0))
        alpha = 0.24 + 0.05 * np.sin(t / 20.0) + rng.normal(0.0, 0.01)
        u = np.array([v, alpha])
        state = ackerman_step_np(state, u, dt, sc.l, sc.h, sc.a, sc.b)
        controls.append(u)
        traj.append(state)
    sc.traj = np.asarray(traj)
    sc.controls_true = np.asarray(controls)
    return sc


def generate_measurements(rng: np.random.Generator, sc: Scenario,
                          pose) -> np.ndarray:
    """One pose's returns [K, 2] (range, bearing): the landmarks in the
    field of view detected with probability pd, with Gaussian noise, and
    Poisson(clutter_rate) clutter uniform in the field of view, shuffled."""
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


@dataclass
class Stream:
    """A run's inputs on the host: step t takes controls[t] (the noisy
    odometry from pose t - 1 to t; row 0 is unused, step 0 does not
    predict) and the measurement set rb[t][:count[t]]."""

    rb: np.ndarray          # [T, M, 2] float32, zero past count
    valid: np.ndarray       # [T, M] bool, a prefix of count[t] slots
    count: np.ndarray       # [T] int
    controls: np.ndarray    # [T, 2] float64
    start_pose: np.ndarray  # [3] the scenario's first pose
    n_cut: int              # steps whose returns exceeded M


def make_stream(traffic: dict, seed: int, n_steps: int,
                max_measurements: int) -> Stream:
    """The mix ``traffic`` (a traffic file's dict) over n_steps steps. The
    site, the landmarks and the course, comes from the mix's
    ``scene_seed``, so every run drives the same course past the same
    landmarks; the odometry noise, the detections, their noise and the
    clutter come from ``seed``. A set of more than max_measurements
    returns keeps its first ones, as the port's
    ``io/loaders.py::pad_measurement_sets`` cuts it."""
    rng = np.random.default_rng(seed)
    sensor = dict(max_range=traffic["max_range"],
                  max_bearing=traffic["max_bearing"],
                  std_range=traffic["std_range"],
                  std_bearing=traffic["std_bearing"],
                  clutter_rate=traffic["clutter"], pd=traffic["pd"])
    sc = make_scenario(np.random.default_rng(traffic["scene_seed"]),
                       n_landmarks=traffic["n_landmarks"],
                       n_steps=n_steps - 1, dt=traffic["dt"],
                       map_extent=traffic["map_extent"], **sensor)
    controls = np.zeros((n_steps, 2))
    controls[1:] = sc.controls_true + rng.normal(
        0.0, traffic["control_noise"], (n_steps - 1, 2))
    m = max_measurements
    rb = np.zeros((n_steps, m, 2), np.float32)
    valid = np.zeros((n_steps, m), bool)
    count = np.zeros(n_steps, np.int64)
    n_cut = 0
    for t in range(n_steps):
        z = generate_measurements(rng, sc, sc.traj[t])
        k = min(len(z), m)
        n_cut += len(z) > m
        rb[t, :k] = z[:k]
        valid[t, :k] = True
        count[t] = k
    return Stream(rb=rb, valid=valid, count=count, controls=controls,
                  start_pose=sc.traj[0].copy(), n_cut=n_cut)

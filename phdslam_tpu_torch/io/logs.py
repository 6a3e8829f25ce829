"""State-estimate log writer, format-compatible with the reference. A copy
of ``phdslam_tpu/io/logs.py``: both packages write the same bytes.

``state_estimateXXXXX.log``: 6 lines per step (writeLog,
src/main.cpp:848-954; README documents 5 — the code also writes resample
indices as line 5 and the cardinality distribution as line 6):

  1. expected pose: px py ptheta vx vy vtheta
  2. static map: repeated [weight mean(2) cov(4, column-major)]
  3. dynamic map: repeated [weight mean(4) cov(16, column-major)]
  4. log particle weights (repeated nPredictParticles times at t=0 so all
     lines have equal length — the shotgun-padding rule of
     src/main.cpp:902-910); NOTE the reference emits weights line before
     poses line: order is (pose, static, dynamic, weights, poses, resample,
     cardinality)
  5. particle poses (6 values each, same t=0 repetition)
  6. resample indices
  7. cardinality distribution (zeros for PHD)

This file layout is the compatibility contract consumed by
matlab/plotPhdSlam.m, python/plot_phdslam.py and python/batch_analyze.py.

Also provides ``loopTime.log`` appending (src/main.cpp:1300-1305) and a
structured JSONL metrics stream (rebuild addition).
"""

from __future__ import annotations

import json
import os

import numpy as np


def _fmt(x) -> str:
    """Format a float the way C++ default ostream does (6 significant
    digits, no trailing zeros beyond precision)."""
    v = float(x)
    if v != v:  # nan
        return "nan"
    s = f"{v:.6g}"
    return s


def write_state_estimate_log(
        directory: str, t: int, expected_pose,
        static_w, static_mean, static_cov,
        dynamic_w=None, dynamic_mean=None, dynamic_cov=None,
        particle_log_weights=None, particle_poses=None,
        resample_idx=None, cardinality=None, max_cardinality: int = 256,
        is_cphd: bool = False, repeat: int = 1):
    """Write one state_estimateXXXXX.log file.

    static_cov entries are written column-major (the reference's Gaussian2D
    cov[4] layout, src/slamtypes.h:123-127); for symmetric 2x2 the order is
    irrelevant, but 4x4 dynamic covs are transposed accordingly.
    """
    path = os.path.join(directory, f"state_estimate{t:05d}.log")
    lines = []
    lines.append(" ".join(_fmt(v) for v in np.asarray(expected_pose)) + " ")

    parts = []
    sw = np.asarray(static_w)
    sm = np.asarray(static_mean)
    sc = np.asarray(static_cov)
    for i in range(len(sw)):
        if sw[i] <= 0:
            continue
        parts.append(_fmt(sw[i]))
        parts.extend(_fmt(v) for v in sm[i])
        parts.extend(_fmt(v) for v in sc[i].T.reshape(-1))  # column-major
    lines.append(" ".join(parts) + (" " if parts else ""))

    parts = []
    if dynamic_w is not None:
        dw = np.asarray(dynamic_w)
        dm = np.asarray(dynamic_mean)
        dc = np.asarray(dynamic_cov)
        for i in range(len(dw)):
            if dw[i] <= 0:
                continue
            parts.append(_fmt(dw[i]))
            parts.extend(_fmt(v) for v in dm[i])
            parts.extend(_fmt(v) for v in dc[i].T.reshape(-1))
    lines.append(" ".join(parts) + (" " if parts else ""))

    lw = np.asarray(particle_log_weights)
    lines.append(" ".join(_fmt(v) for v in np.tile(lw, repeat)) + " ")

    poses = np.asarray(particle_poses)
    pose_strs = [" ".join(_fmt(v) for v in p) for p in poses]
    lines.append(" ".join(pose_strs * repeat) + " ")

    idx = np.asarray(resample_idx)
    lines.append(" ".join(str(int(v)) for v in idx) + " ")

    if is_cphd and cardinality is not None:
        cn = np.asarray(cardinality)
        lines.append(" ".join(_fmt(v) for v in cn) + " ")
    else:
        lines.append(" ".join(["0"] * (max_cardinality + 1)) + " ")

    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def append_loop_time(directory: str, elapsed_ms: float):
    with open(os.path.join(directory, "loopTime.log"), "a") as f:
        f.write(f"{_fmt(elapsed_ms)}\n")


def append_predict_time(directory: str, elapsed_ms: float):
    with open(os.path.join(directory, "predicttime.log"), "a") as f:
        f.write(f"{_fmt(elapsed_ms)}\n")


def append_metrics_jsonl(directory: str, record: dict):
    """Structured per-step metrics (rebuild addition; no reference analog)."""
    with open(os.path.join(directory, "metrics.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")


def read_state_estimate_log(path: str):
    """Parse a state_estimate log back (the contract batch_analyze.py
    relies on: map line strided 7 for static features,
    python/batch_analyze.py:21-24). Disparity-pipeline logs are detected
    by their 12-DOF camera pose line: the map line is then strided 13
    (w + 3-D mean + 3x3 cov) and particle poses are 12 wide."""
    with open(path) as f:
        lines = f.read().splitlines()
    pose = np.array([float(v) for v in lines[0].split()])
    is_disparity = pose.size == 12
    stride = 13 if is_disparity else 7
    pose_w = 12 if is_disparity else 6
    static_raw = np.array([float(v) for v in lines[1].split()])
    static = static_raw.reshape(-1, stride) if static_raw.size else \
        np.zeros((0, stride))
    dynamic_raw = np.array([float(v) for v in lines[2].split()])
    dynamic = dynamic_raw.reshape(-1, 21) if dynamic_raw.size else \
        np.zeros((0, 21))
    weights = np.array([float(v) for v in lines[3].split()])
    poses = np.array([float(v)
                      for v in lines[4].split()]).reshape(-1, pose_w)
    resample_idx = np.array([int(v) for v in lines[5].split()])
    cardinality = np.array([float(v) for v in lines[6].split()]) \
        if len(lines) > 6 else np.zeros(0)
    return dict(pose=pose, static=static, dynamic=dynamic, weights=weights,
                poses=poses, resample_idx=resample_idx,
                cardinality=cardinality)

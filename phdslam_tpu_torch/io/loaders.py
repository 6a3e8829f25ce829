"""Text-input loaders for the reference dataset formats. A copy of
``phdslam_tpu/io/loaders.py``: both packages read a file the same way.

Formats (src/main.cpp:147-283):
 - measurements.txt : header line, then one time step per line as
   whitespace-separated (range, bearing) pairs — optionally (range,
   bearing, label) triples when measurements are labeled.
 - controls.txt     : header line, then (v_encoder, alpha) per line
   (python-generated variants use commas; both accepted).
 - *_times.txt      : one float per line (reference pops the trailing
   blank-line artifact, src/main.cpp:163).
 - traj.txt         : optional '%' header, 6 floats per line.

Deviations from the reference parser, on purpose: the reference's
``parseMeasurements`` (src/main.cpp:192-208) reads an int label after every
pair even for 2-column files — consuming the integer prefix of the next
range — and appends a spurious (0,0) measurement per line (its removal is
commented out at src/main.cpp:206-207). Both are iostream artifacts, not
algorithm semantics; this loader parses the documented format cleanly.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class MeasurementSet:
    ranges: np.ndarray
    bearings: np.ndarray
    labels: np.ndarray


def _tokens(line: str) -> List[float]:
    line = line.strip()
    if not line:
        return []
    return [float(t) for t in re.split(r"[,\s]+", line) if t]


def load_measurements(path: str, labeled: bool = False) -> List[MeasurementSet]:
    """One MeasurementSet per data line. Lines with an odd token count under
    pair parsing (or not divisible by 3 under labeled parsing) raise."""
    sets: List[MeasurementSet] = []
    with open(path) as f:
        lines = f.readlines()
    start = 1 if lines and lines[0].lstrip().startswith("%") else 0
    for line in lines[start:]:
        vals = _tokens(line)
        if not vals and line.strip() == "":
            # blank lines inside the file are empty measurement sets only if
            # they are not the trailing newline
            continue
        arr = np.asarray(vals, np.float32)
        if labeled:
            arr = arr.reshape(-1, 3)
            sets.append(MeasurementSet(arr[:, 0], arr[:, 1],
                                       arr[:, 2].astype(np.int32)))
        else:
            arr = arr.reshape(-1, 2)
            sets.append(MeasurementSet(
                arr[:, 0], arr[:, 1],
                np.zeros(arr.shape[0], np.int32)))
    return sets


def load_controls(path: str) -> np.ndarray:
    """Returns [T, 2] array of (v_encoder, alpha)."""
    out = []
    with open(path) as f:
        lines = f.readlines()
    start = 1 if lines and lines[0].lstrip().startswith("%") else 0
    for line in lines[start:]:
        vals = _tokens(line)
        if len(vals) >= 2:
            out.append((vals[0], vals[1]))
    return np.asarray(out, np.float32).reshape(-1, 2)


def load_timestamps(path: str) -> Optional[np.ndarray]:
    """Returns [T] float array, or None if the file does not exist
    (timestamps are optional: src/main.cpp:1094)."""
    import os
    if not os.path.exists(path):
        return None
    vals = []
    with open(path) as f:
        for line in f:
            toks = _tokens(line)
            if toks:
                vals.append(toks[0])
    if not vals:
        return None
    return np.asarray(vals, np.float32)


def load_trajectory(path: str) -> np.ndarray:
    """Returns [T, 6] pose array (px, py, ptheta, vx, vy, vtheta)."""
    out = []
    with open(path) as f:
        for line in f:
            if line.lstrip().startswith("%"):
                continue
            vals = _tokens(line)
            if len(vals) >= 6:
                out.append(vals[:6])
    return np.asarray(out, np.float32).reshape(-1, 6)


def pad_measurement_sets(sets: List[MeasurementSet], max_measurements: int):
    """Stack per-step measurement sets into fixed-shape [T, M, ...] arrays
    for `lax.scan` (rb, labels, valid). Overflowing measurements are clamped
    with a warning, like the reference's 256-cap
    (src/phdfilter.cu:3390-3394)."""
    t = len(sets)
    rb = np.zeros((t, max_measurements, 2), np.float32)
    labels = np.zeros((t, max_measurements), np.int32)
    valid = np.zeros((t, max_measurements), bool)
    clamped = 0
    for i, s in enumerate(sets):
        m = len(s.ranges)
        if m > max_measurements:
            clamped += 1
            m = max_measurements
        rb[i, :m, 0] = s.ranges[:m]
        rb[i, :m, 1] = s.bearings[:m]
        labels[i, :m] = s.labels[:m]
        valid[i, :m] = True
    if clamped:
        print(f"Warning: {clamped} steps exceeded max_measurements="
              f"{max_measurements}; extra measurements dropped")
    return rb, labels, valid

"""Reading a ``torch.profiler`` trace of the profiled steps.

The benchmark wraps its own host work of each step in spans
(``record_function``): ``upload`` (the measurement set to the device),
``draws`` (the step's random draws), ``dispatch`` (the call into the
program) and ``pose_read`` (the pose back to the host), inside one
``step`` span. The device's activities are the kernel, copy and set
intervals the profiler records. Busy time is the union of those
intervals (the arithmetic of the port's ``chip_smoke.py::device_busy``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Tuple

HOST_SPANS = ("upload", "draws", "dispatch", "pose_read")
SELECT_RE = re.compile(r"\bselect(_wide)?_kernel\b")
MERGE_RE = re.compile(r"\bmerge(_wide)?_kernel\b")
NCCL_RE = re.compile(r"nccl", re.IGNORECASE)
COPY_RE = re.compile(r"^(Memcpy|Memset)|memcpy|memset", re.IGNORECASE)


@dataclass
class Trace:
    """Device activities (name, start us, end us), the benchmark's host
    spans (name, start us, end us) and the profiled steps' window."""

    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]


def from_profiler(prof) -> Trace:
    """The Trace of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    dev, host, steps = [], [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # spans (the benchmark's, and c10d's around a collective) also
            # appear on the device's timeline as annotations: not work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in HOST_SPANS or e.name == "step"):
                dev.append(span)
        elif e.name in HOST_SPANS:
            host.append(span)
        elif e.name == "step":
            steps.append(span)
    window = (min(s[1] for s in steps), max(s[2] for s in steps)) \
        if steps else (0.0, 0.0)
    return Trace(device=dev, host=host, window=window)


def busy_intervals(trace: Trace) -> List[Tuple[float, float]]:
    """The union of the device's intervals inside the window, sorted."""
    lo, hi = trace.window
    spans = sorted((max(a, lo), min(b, hi)) for _, a, b in trace.device
                   if b > lo and a < hi)
    out: List[Tuple[float, float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_us(trace: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace))


def idle_gaps(trace: Trace):
    """[(host span the gap's middle falls in, gap us)] for every stretch
    of the window with nothing on the device, longest first."""
    lo, hi = trace.window
    gaps, reach = [], lo
    for a, b in busy_intervals(trace) + [(hi, hi)]:
        if a > reach:
            gaps.append((reach, a))
        reach = max(reach, b)
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = "other"
        for n, s, e in trace.host:
            if s <= mid <= e:
                name = n
                break
        out.append((name, b - a))
    out.sort(key=lambda g: -g[1])
    return out


def kernel_us(trace: Trace, pattern) -> float:
    """Summed device time of the activities whose name matches."""
    return sum(b - a for n, a, b in trace.device if pattern.search(n))


def glue_us(trace: Trace) -> float:
    """Device time of every kernel that is neither the port's select nor
    merge kernel, nor a collective, nor a copy or set."""
    return sum(b - a for n, a, b in trace.device
               if not (SELECT_RE.search(n) or MERGE_RE.search(n)
                       or NCCL_RE.search(n) or COPY_RE.search(n)))


def top_ops(trace: Trace, n: int = 10):
    """[(name, seconds)] of the device activities with the most time, by
    name."""
    tot = {}
    for name, a, b in trace.device:
        tot[name] = tot.get(name, 0.0) + (b - a)
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], us / 1e6] for name, us in rows]

"""Spans of the SLAM step: host and device ms of each stage, named on the
profiler's timeline.

    from phdslam_tpu_torch.spans import span

    with span("predict"):
        ...

``filter/step.py::slam_step`` opens the root span, ``slam_step``, on the
state's device; under it ``predict``, ``update``, ``estimate`` and
``resample``, and on the static GM-PHD branch ``filter/update.py`` opens
``preupdate``, ``select``, ``normalizers``, ``pool`` and ``merge`` inside
``update``.

Off, the default, ``span`` reads one flag (the profiler's own "enabled"
flag, ``torch.autograd._profiler_enabled()``, or ``enable``'s) and returns a
shared no-op context: no object, no CUDA event and no record.

On, because a ``torch.profiler`` (or the autograd profiler) records or
``enable(True)`` was called, each span

- where a profiler records, opens ``torch.profiler.record_function(name)``:
  the span lies on the profiler's timeline, on the kernels' clock, and the
  profiler ties each kernel launched inside it to it (without one it would
  record nothing, so it is skipped);
- takes its host start and end (``perf_counter_ns``), its parent span and
  its step: every span of one ``slam_step`` call carries that call's
  number (``ROOT`` spans count the steps);
- where its root names a CUDA device, records a timing event at each end
  on the stream current when the root opened, from a reused pool. Its
  device ms run
  from the stream reaching its first work to the end of its last, idle
  inside included. Nothing synchronises: a closed span is resolved once
  its end event is done (queried when a root span closes) or by
  ``summary()``, which waits for the rest.

The record is per name (``summary()``): calls, host ms, host self ms,
device ms and device self ms (self: less the span's child spans), the
parents' names and the steps seen. While the stream captures a CUDA graph
the spans do nothing. One stack of open spans per process: the spans are
for one thread.
"""

from __future__ import annotations

import time
from collections import deque

import torch

#: the span of one step; opening one begins a step
ROOT = "slam_step"

_profiling = torch.autograd._profiler_enabled
_enabled = False
_stack = []              # open spans, innermost last
_pending = deque()       # closed spans with events, in closing order
_pool = {}               # device -> free timing events
_record = {}             # name -> _Total
_step = 0                # ROOT spans opened since the last reset


class _Off:
    """The shared context of a span that is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


def enable(on: bool = True):
    """Record spans whether or not a profiler records (``on``), or only
    under one (the default)."""
    global _enabled
    _enabled = bool(on)


def span(name: str, device=None):
    """The context of stage ``name``. ``device``: where the stage's work
    runs (a root span's; others take their parent's). Off: a shared
    no-op."""
    if not (_enabled or _profiling()):
        return _OFF
    return _Span(name, device)


def reset():
    """Forget the record, the pending spans and the step count."""
    global _step
    _record.clear()
    _pending.clear()
    _step = 0


def summary() -> dict:
    """{name: calls, host_ms, host_self_ms, device_ms, device_self_ms,
    parents, steps, step}, after resolving every closed span (waits for
    their events). device_ms and device_self_ms are None for a span that
    never ran on a CUDA device; parents is the sorted tuple of the names
    it ran under, steps the number of steps it ran in, step the last."""
    _resolve(wait=True)
    return {n: t.as_dict() for n, t in _record.items()}


class _Total:
    __slots__ = ("calls", "host_ns", "host_self_ns", "device_calls",
                 "device_ms", "device_self_ms", "parents", "steps", "step")

    def __init__(self):
        self.calls = self.host_ns = self.host_self_ns = 0
        self.device_calls = self.steps = 0
        self.device_ms = self.device_self_ms = 0.0
        self.parents = set()
        self.step = None

    def as_dict(self):
        timed = self.device_calls > 0
        return dict(calls=self.calls, host_ms=self.host_ns / 1e6,
                    host_self_ms=self.host_self_ns / 1e6,
                    device_ms=self.device_ms if timed else None,
                    device_self_ms=self.device_self_ms if timed else None,
                    parents=tuple(sorted(self.parents)), steps=self.steps,
                    step=self.step)


def _total(name):
    t = _record.get(name)
    if t is None:
        t = _record[name] = _Total()
    return t


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def _stream(device):
    return torch.cuda.current_stream(device)


def _event(device, stream):
    """A timing event of device's pool recorded now on stream."""
    free = _pool.setdefault(device, [])
    ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Span:
    __slots__ = ("name", "device", "stream", "parent", "step", "fn", "t0",
                 "child_host_ns", "child_device_ms", "ev0", "ev1", "live")

    def __init__(self, name, device):
        self.name = name
        self.device = None if device is None else torch.device(device)

    def __enter__(self):
        global _step
        parent = _stack[-1] if _stack else None
        if self.device is None and parent is not None:
            self.device = parent.device
        self.live = not _capturing()
        if not self.live:
            return None
        cuda = self.device is not None and self.device.type == "cuda"
        if self.name == ROOT:
            _step += 1
            self.step = _step
        else:
            self.step = None if parent is None else parent.step
        self.parent = parent
        self.child_host_ns = 0
        self.child_device_ms = 0.0
        self.fn = None
        if _profiling():
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        self.ev0 = self.ev1 = None
        if cuda:
            self.stream = parent.stream if (
                parent is not None and parent.device == self.device) \
                else _stream(self.device)
            self.ev0 = _event(self.device, self.stream)
        _stack.append(self)
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        if not self.live:
            return False
        host = time.perf_counter_ns() - self.t0
        if self.ev0 is not None:
            self.ev1 = _event(self.device, self.stream)
        if self.fn is not None:
            self.fn.__exit__(*exc)
        _stack.pop()
        parent = self.parent
        t = _total(self.name)
        t.calls += 1
        t.host_ns += host
        t.host_self_ns += host - self.child_host_ns
        if parent is not None:
            parent.child_host_ns += host
            t.parents.add(parent.name)
        if self.step != t.step:
            t.steps += 1
            t.step = self.step
        if self.ev0 is not None:
            _pending.append(self)
        else:
            self.parent = None
        if self.name == ROOT:
            _resolve(wait=False)
        return False


def _resolve(wait: bool):
    """Fold the closed spans' device ms into the record, oldest first;
    without ``wait`` stop at the first whose end event is not done."""
    while _pending:
        s = _pending[0]
        if not wait and not s.ev1.query():
            return
        if wait:
            s.ev1.synchronize()
        ms = s.ev0.elapsed_time(s.ev1)
        _pending.popleft()
        _pool.setdefault(s.device, []).extend((s.ev0, s.ev1))
        t = _total(s.name)
        t.device_calls += 1
        t.device_ms += ms
        t.device_self_ms += ms - s.child_device_ms
        if s.parent is not None:
            s.parent.child_device_ms += ms
        s.parent = s.ev0 = s.ev1 = s.stream = None

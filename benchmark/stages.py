"""The stage metrics' reading of the port's spans
(``phdslam_tpu_torch/spans.py``): device ms a step in one span of the
static GM-PHD step.

The spans record only while a profiler records, so after a traced run the
spans' record (``spans.summary()``) holds the profiled steps alone. A
stage's device ms run on the stream from the stage's first work to the end
of its last, idle inside included. None where the program has no spans
module, or the span never ran or has no device time (on the CPU).
"""

from __future__ import annotations


def device_ms_a_step(name: str):
    """The device ms span ``name`` took over the recorded steps, over the
    root span's calls (the ``slam_step`` calls), or None."""
    try:
        from phdslam_tpu_torch import spans
    except ImportError:
        return None
    record = spans.summary()
    root, stage = record.get(spans.ROOT), record.get(name)
    if not root or not stage or stage["device_ms"] is None:
        return None
    return stage["device_ms"] / root["calls"]

"""stage.normalizers_ms: device ms a step in the port's ``normalizers`` span,
the per-measurement normalizers, the birth weights and the particle
weighting ``dw`` after the select; from the spans' record of the profiled
steps (``benchmark/stages.py``)."""

from benchmark import stages


def read(ctx):
    return stages.device_ms_a_step("normalizers")

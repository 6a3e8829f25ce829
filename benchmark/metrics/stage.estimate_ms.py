"""stage.estimate_ms: device ms a step in the port's ``estimate`` span, the
weight normalisation, the expected pose and nEff; from the spans' record of
the profiled steps (``benchmark/stages.py``)."""

from benchmark import stages


def read(ctx):
    return stages.device_ms_a_step("estimate")

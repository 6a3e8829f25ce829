"""stage.resample_ms: device ms a step in the port's ``resample`` span, the
resample's indices, the trigger and the particles' gather; from the spans'
record of the profiled steps (``benchmark/stages.py``)."""

from benchmark import stages


def read(ctx):
    return stages.device_ms_a_step("resample")

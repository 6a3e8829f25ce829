"""stage.predict_ms: device ms a step in the port's ``predict`` span, the
shotgun expansion and the motion model's sub-steps
(``filter/step.py::predicted_state``); from the spans' record of the
profiled steps (``benchmark/stages.py``)."""

from benchmark import stages


def read(ctx):
    return stages.device_ms_a_step("predict")

"""stage.preupdate_ms: device ms a step in the port's ``preupdate`` span, the
Kalman pre-update, [P, F] channel arithmetic
(``filter/update.py::kalman_preupdate``); from the spans' record of the
profiled steps (``benchmark/stages.py``)."""

from benchmark import stages


def read(ctx):
    return stages.device_ms_a_step("preupdate")

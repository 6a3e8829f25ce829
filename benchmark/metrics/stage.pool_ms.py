"""stage.pool_ms: device ms a step in the port's ``pool`` span, the merge pool:
the prune, the births' means and covariances and the six channels' ``cat``s
(``filter/update.py::pool_static_sel``); from the spans' record of the
profiled steps (``benchmark/stages.py``)."""

from benchmark import stages


def read(ctx):
    return stages.device_ms_a_step("pool")

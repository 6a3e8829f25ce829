"""stage.merge_ms: device ms a step in the port's ``merge`` span, the merge
kernel and its wrapper's glue (``filter/update.py::merge_pool``); from the
spans' record of the profiled steps (``benchmark/stages.py``)."""

from benchmark import stages


def read(ctx):
    return stages.device_ms_a_step("merge")

"""stage.select_ms: device ms a step in the port's ``select`` span, the select
kernel and its wrapper's glue (``kernels/select.py``; the by-index gather
under ``select_by_index``); from the spans' record of the profiled steps
(``benchmark/stages.py``)."""

from benchmark import stages


def read(ctx):
    return stages.device_ms_a_step("select")

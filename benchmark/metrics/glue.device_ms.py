"""glue.device_ms: profiled device ms a step of every kernel that is not
the port's select or merge kernel (names from ``csrc/``), a collective,
a copy or a set: the update glue, prediction, resample and estimate."""

from benchmark import trace as T


def read(ctx):
    us = T.glue_us(ctx["trace"])
    return us / 1e3 / ctx["steps"] if us > 0 else None

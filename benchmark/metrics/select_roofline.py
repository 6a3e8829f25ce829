"""select_roofline: the select kernel's share of its roofline, in %:
the least time of its launches' work (bytes over 3.35 TB/s or float32
operations over 67 TFLOP/s, the larger, counted from the launch's inputs:
``counts.select_bytes``, ``counts.select_ops``) over its profiled device
time. Nothing when no select kernel ran."""

from benchmark import trace as T


def read(ctx):
    us = T.kernel_us(ctx["trace"], T.SELECT_RE)
    if us <= 0 or ctx["select_bound_ms"] <= 0:
        return None
    return 100.0 * ctx["select_bound_ms"] / (us / 1e3)

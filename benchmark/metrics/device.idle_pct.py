"""device.idle_pct: 100 x (1 - profiled device busy ms a step / the
unprofiled window's wall ms a step of the same run): the profiler slows
the host, not the device's work (the port's ``chip_smoke.py``
phase_profile arithmetic)."""

from benchmark import trace as T


def read(ctx):
    busy = T.busy_us(ctx["trace"])
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / 1e3 / ctx["steps"] / ctx["wall_ms"])

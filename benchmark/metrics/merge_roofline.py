"""merge_roofline: the merge kernel's share of its roofline, in %: the
pool's bytes read once and the map's written once, over 3.35 TB/s
(``counts.merge_bytes``; the candidate tests are not counted, so this is
a floor), over its profiled device time. Nothing when no merge ran."""

from benchmark import trace as T


def read(ctx):
    us = T.kernel_us(ctx["trace"], T.MERGE_RE)
    if us <= 0 or ctx["merge_bound_ms"] <= 0:
        return None
    return 100.0 * ctx["merge_bound_ms"] / (us / 1e3)

"""mesh.nccl_device_ms: profiled device ms a step of NCCL's kernels on
rank 0. Nothing when none ran."""

from benchmark import trace as T


def read(ctx):
    us = T.kernel_us(ctx["trace"], T.NCCL_RE)
    return us / 1e3 / ctx["steps"] if us > 0 else None

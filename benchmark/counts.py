"""The yardstick's peaks and the work counts of the kernels' launches.

The counts take the work a launch's inputs need, whatever implements it,
so that a kernel's roofline share keeps its meaning when the kernel is
redesigned: each input byte read once, each output byte written once.
"""

from __future__ import annotations

#: one NVIDIA H100 SXM (data sheet, 700 W): float32 outside the tensor
#: cores, and HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
#: float32 operations of one (particle, measurement, slot) likelihood
#: term: innovation (1), bearing wrap (4), quadratic form (9), clamp (1),
#: exponent (2), exp (1), the sum (1), normalise and prune (2); then one
#: compare per top-k round
SELECT_TRIPLE_OPS = 22


def bound_ms(n_bytes: float, n_ops: float) -> float:
    """The least time of the work on the card: bytes over the bandwidth
    or operations over the float32 peak, the larger."""
    return max(n_bytes / PEAK_BYTES, n_ops / PEAK_F32_OPS) * 1e3


def select_bytes(P: int, F: int, M: int, k1: int) -> int:
    """The select launch: 16 [P, F] float32 channels and the measurements
    in; the [P, M] normalisers, the compatibility flags and seven
    [P, M, k1] payload channels out."""
    return 4 * (16 * P * F + 2 * M + 1) + P * M * (4 + 1 + k1 * 7 * 4)


def select_ops(P: int, F: int, n_valid: int, k1: int) -> int:
    """The likelihood terms of the valid measurements over every slot."""
    return P * n_valid * F * (SELECT_TRIPLE_OPS + k1)


def merge_bytes(P: int, K: int, cap: int) -> int:
    """The merge launch: six [P, K] pool channels in, six [P, cap] out.
    Its candidate tests depend on the pool and are not counted, so its
    share is a floor."""
    return 4 * 6 * P * (K + cap)


def pool_size(F: int, M: int, k1: int) -> int:
    """The static update's pool: the kept map, k1 detection terms per
    measurement, one birth per measurement."""
    return F + M * k1 + M

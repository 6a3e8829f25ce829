"""State estimates (``phdslam_tpu/filter/estimate.py``): expected pose, the
MAP particle's map and its expected landmark count. The EAP map (host-side
greedy reduction of every particle's map) is not ported yet."""

from __future__ import annotations

import torch

from phdslam_tpu_torch.filter.state import Gaussian2DMixture, SlamState


def expected_pose(state: SlamState):
    """Weighted mean of the particle poses."""
    w = torch.exp(state.log_weights)
    return (w[:, None] * state.pose).sum(0)


def map_map_static(state: SlamState) -> Gaussian2DMixture:
    """MAP map: the highest-weight particle's static map ([F] channels)."""
    idx = torch.argmax(state.log_weights).reshape(1)
    return state.map_static.map(lambda t: t.index_select(0, idx)[0])


def expected_cardinality(state: SlamState):
    """Expected landmark count of the MAP particle's map."""
    return map_map_static(state).w.sum()

"""State estimates (``phdslam_tpu/filter/estimate.py``): expected pose, the
MAP particle's static and dynamic maps and its expected landmark count, on
the device; the EAP map (every particle's mixture scaled by its weight,
then greedily reduced) on the host, in NumPy, since its length depends on
the data and it only feeds the logs."""

from __future__ import annotations

import numpy as np
import torch

from phdslam_tpu_torch.filter.state import (Gaussian2DMixture,
                                            Gaussian4DMixture, SlamState)
from phdslam_tpu_torch.ops.gm import reduce_mixture_np


def expected_pose(state: SlamState, n_runs=None):
    """Weighted mean of the particle poses: [6], or [R, 6] for each of
    ``n_runs`` runs (``filter/runs.py``)."""
    return weighted_pose(state.log_weights, state.pose, n_runs)


def weighted_pose(log_weights, pose, n_runs=None):
    """``expected_pose`` of log weights [P] and poses [P, 6] (a sharded
    step passes the gathered ones)."""
    wp = torch.exp(log_weights)[:, None] * pose
    if n_runs is None:
        return wp.sum(0)
    return wp.reshape(n_runs, -1, wp.shape[-1]).sum(1)


def map_map_static(state: SlamState) -> Gaussian2DMixture:
    """MAP map: the highest-weight particle's static map ([F] channels)."""
    idx = torch.argmax(state.log_weights).reshape(1)
    return state.map_static.map(lambda t: t.index_select(0, idx)[0])


def map_map_dynamic(state: SlamState) -> Gaussian4DMixture:
    """MAP dynamic map: the highest-weight particle's dynamic map."""
    idx = torch.argmax(state.log_weights).reshape(1)
    return state.map_dynamic.map(lambda t: t.index_select(0, idx)[0])


def expected_cardinality(state: SlamState):
    """Expected landmark count of the MAP particle's map."""
    return map_map_static(state).w.sum()


def eap_map_np(weights_log, gm_w, gm_mean, gm_cov, min_separation):
    """Expected (EAP) map from host arrays: log weights [P], mixture w
    [P, F], mean [P, F, d], cov [P, F, d, d]. Returns (w, mean, cov)."""
    wl = np.asarray(weights_log)
    w = np.asarray(gm_w) * np.exp(wl)[:, None]
    valid = w > 0
    if not valid.any():
        d = np.asarray(gm_mean).shape[-1]
        return np.zeros((0,)), np.zeros((0, d)), np.zeros((0, d, d))
    return reduce_mixture_np(w[valid], np.asarray(gm_mean)[valid],
                             np.asarray(gm_cov)[valid], min_separation)

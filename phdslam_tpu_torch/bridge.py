"""Carry a SLAM state between the JAX package and the port, as numpy.

``state_from_numpy`` takes the fields of a JAX ``SlamState`` whose leaves are
numpy arrays (what ``jax.device_get(state)`` returns) or the nested dict that
``state_to_numpy`` writes, and builds the port's tensors. The bridge itself
imports no JAX: the caller does the ``device_get``.

On the static path ``map_dynamic`` has width 0 and ``cardinality`` /
``cn_birth`` are None; both round-trip as they are.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from phdslam_tpu_torch.filter.state import (Gaussian2DMixture,
                                            Gaussian4DMixture, SlamState)

_G2 = ("w", "mx", "my", "c00", "c01", "c11")
_G4 = ("w", "mean_channels", "cov_channels")


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tensor(a, device, dtype=None):
    if a is None:
        return None
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def state_from_numpy(d, device=None) -> SlamState:
    ms, md = _get(d, "map_static"), _get(d, "map_dynamic")
    return SlamState(
        pose=_tensor(_get(d, "pose"), device, np.float32),
        log_weights=_tensor(_get(d, "log_weights"), device, np.float32),
        map_static=Gaussian2DMixture(
            **{k: _tensor(_get(ms, k), device, np.float32) for k in _G2}),
        map_dynamic=Gaussian4DMixture(
            **{k: _tensor(_get(md, k), device, np.float32) for k in _G4}),
        resample_idx=_tensor(_get(d, "resample_idx"), device, np.int32),
        variances=_tensor(_get(d, "variances"), device, np.float32),
        cardinality=_tensor(_get(d, "cardinality"), device, np.float32),
        cn_birth=_tensor(_get(d, "cn_birth"), device, np.float32),
    )


def state_to_numpy(s: SlamState) -> dict:
    """Nested dict of numpy arrays with the JAX ``SlamState`` field names;
    ``phdslam_tpu.filter.state.SlamState(**d)`` rebuilds it once the two
    map dicts are wrapped in their mixture classes."""
    host = lambda t: None if t is None else t.detach().cpu().numpy()
    return dict(
        pose=host(s.pose),
        log_weights=host(s.log_weights),
        map_static={k: host(getattr(s.map_static, k)) for k in _G2},
        map_dynamic={k: host(getattr(s.map_dynamic, k)) for k in _G4},
        resample_idx=host(s.resample_idx),
        variances=host(s.variances),
        cardinality=host(s.cardinality),
        cn_birth=host(s.cn_birth),
    )

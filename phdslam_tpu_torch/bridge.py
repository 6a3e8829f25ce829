"""Carry a SLAM state between the JAX package and the port, as numpy.

``state_from_numpy`` takes the fields of a JAX ``SlamState`` whose leaves are
numpy arrays (what ``jax.device_get(state)`` returns) or the nested dict that
``state_to_numpy`` writes, and builds the port's tensors. The bridge itself
imports no JAX: the caller does the ``device_get``.
``disparity_state_from_numpy`` / ``disparity_state_to_numpy`` do the same
for the disparity pipeline's ``DisparityState``.

On the static path ``map_dynamic`` has width 0 and ``cardinality`` /
``cn_birth`` are None; both round-trip as they are. Under CPHD both are
[P, N+1] log-pmfs. ``host_view`` gives the numpy copies the host-side
writers read (the ``.mat`` export, the EAP map) with the JAX state's
attribute names, the maps' mean and covariance views included.
"""

from __future__ import annotations

from collections.abc import Mapping
from types import SimpleNamespace

import numpy as np
import torch

from phdslam_tpu_torch.filter.disparity import DisparityState
from phdslam_tpu_torch.filter.state import (Gaussian2DMixture,
                                            Gaussian4DMixture, SlamState)

_G2 = ("w", "mx", "my", "c00", "c01", "c11")
_G4 = ("w", "mean_channels", "cov_channels")
_DISP = ("pose", "log_weights", "w", "px", "py", "pz")


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


def unpack_cov_channels(ch):
    """[..., 10, F] channels in the S4 order -> [..., F, 4, 4]."""
    cov = np.zeros(ch.shape[:-2] + (ch.shape[-1], 4, 4), ch.dtype)
    k = 0
    for i in range(4):
        for j in range(i, 4):
            cov[..., i, j] = cov[..., j, i] = ch[..., k, :]
            k += 1
    return cov


def host_view(s: SlamState) -> SimpleNamespace:
    """Numpy copies of a state with the attributes of the JAX package's
    ``SlamState`` on the host: pose, log_weights, variances, resample_idx,
    cardinality, and both maps with w, mean ([P, F, 2] and [P, F, 4]), cov
    ([P, F, 2, 2] and [P, F, 4, 4]) and max_features. What the ``.mat``
    writer and the EAP map read."""
    d = state_to_numpy(s)
    ms, md = d["map_static"], d["map_dynamic"]
    c01 = ms["c01"]
    static = SimpleNamespace(
        w=ms["w"], mean=np.stack([ms["mx"], ms["my"]], axis=-1),
        cov=np.stack([np.stack([ms["c00"], c01], axis=-1),
                      np.stack([c01, ms["c11"]], axis=-1)], axis=-2),
        max_features=ms["w"].shape[-1])
    dynamic = SimpleNamespace(
        w=md["w"], mean=np.moveaxis(md["mean_channels"], -2, -1),
        cov=unpack_cov_channels(md["cov_channels"]),
        max_features=md["w"].shape[-1])
    return SimpleNamespace(
        pose=d["pose"], log_weights=d["log_weights"],
        variances=d["variances"], resample_idx=d["resample_idx"],
        cardinality=d["cardinality"], map_static=static, map_dynamic=dynamic)


def disparity_state_from_numpy(d, device=None) -> DisparityState:
    return DisparityState(
        **{k: _tensor(_get(d, k), device, np.float32) for k in _DISP},
        resample_idx=_tensor(_get(d, "resample_idx"), device, np.int32))


def disparity_state_to_numpy(s: DisparityState) -> dict:
    """Dict of numpy arrays with the JAX ``DisparityState`` field names."""
    return {k: getattr(s, k).detach().cpu().numpy()
            for k in _DISP + ("resample_idx",)}

"""The SLAM state as dataclasses of tensors.

Port of ``phdslam_tpu/filter/state.py``. The layout is the same: a map slot
is empty iff its weight is exactly 0 (with an identity covariance), every
shape is fixed, and the 2-D static map is six ``[P, F]`` scalar channels.
Pose layout: ``[px, py, ptheta, vx, vy, vtheta]``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch


class _TensorTree:
    """``replace``, ``to`` and ``map`` for dataclasses whose fields are
    tensors, nested tensor dataclasses, or None."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def map(self, fn):
        """Apply ``fn`` to every tensor field, recursing into nested
        dataclasses; None and plain Python values pass through."""
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, _TensorTree):
                v = v.map(fn)
            elif isinstance(v, torch.Tensor):
                v = fn(v)
            out[f.name] = v
        return dataclasses.replace(self, **out)

    def to(self, device):
        return self.map(lambda t: t.to(device))


@dataclass
class Gaussian2DMixture(_TensorTree):
    """Channelized padded 2-D Gaussian mixture: six ``[..., F]`` channels."""

    w: torch.Tensor
    mx: torch.Tensor
    my: torch.Tensor
    c00: torch.Tensor
    c01: torch.Tensor
    c11: torch.Tensor

    @property
    def valid(self) -> torch.Tensor:
        return self.w > 0

    @classmethod
    def empty(cls, batch_shape, max_features: int, device=None,
              dtype=torch.float32) -> "Gaussian2DMixture":
        shape = tuple(batch_shape) + (max_features,)
        z = lambda: torch.zeros(shape, dtype=dtype, device=device)
        one = lambda: torch.ones(shape, dtype=dtype, device=device)
        return cls(w=z(), mx=z(), my=z(), c00=one(), c01=z(), c11=one())


@dataclass
class Gaussian4DMixture(_TensorTree):
    """Channelized padded 4-D mixture: ``w [..., Fd]``, ``mean_channels
    [..., 4, Fd]``, ``cov_channels [..., 10, Fd]`` (symmetric 4x4 packed in
    row-major upper-triangle order). The static path carries it with
    ``Fd = 0``."""

    w: torch.Tensor
    mean_channels: torch.Tensor
    cov_channels: torch.Tensor

    @classmethod
    def empty(cls, batch_shape, max_features: int, device=None,
              dtype=torch.float32) -> "Gaussian4DMixture":
        bs = tuple(batch_shape)
        cov = torch.zeros(bs + (10, max_features), dtype=dtype, device=device)
        cov[..., [0, 4, 7, 9], :] = 1.0
        return cls(
            w=torch.zeros(bs + (max_features,), dtype=dtype, device=device),
            mean_channels=torch.zeros(bs + (4, max_features), dtype=dtype,
                                      device=device),
            cov_channels=cov)


@dataclass
class SlamState(_TensorTree):
    """Per-particle pose, normalized log weight, static and dynamic maps,
    variance estimate and the last resample indices. ``cardinality`` and
    ``cn_birth`` are CPHD-only and None on the PHD path."""

    pose: torch.Tensor                 # [P, 6]
    log_weights: torch.Tensor          # [P]
    map_static: Gaussian2DMixture      # [P, F] channels
    map_dynamic: Gaussian4DMixture     # [P, Fd] channels
    resample_idx: torch.Tensor         # [P] int32
    variances: torch.Tensor            # [P]
    cardinality: Optional[torch.Tensor] = None
    cn_birth: Optional[torch.Tensor] = None

    @property
    def n_particles(self) -> int:
        return self.pose.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pose.device

    @classmethod
    def create(cls, config, device=None,
               dtype=torch.float32) -> "SlamState":
        """All particles at the configured initial pose, uniform weights."""
        if config.filterType == 1:
            raise NotImplementedError(
                "CPHD state (filter_type = 1) is ROADMAP Queue 1 item 9")
        n = config.n_particles
        pose0 = torch.tensor([config.x0, config.y0, config.yaw0, config.vx0,
                              config.vy0, config.vyaw0], dtype=dtype,
                             device=device)
        f_dynamic = config.maxFeatures if config.featureModel != 0 else 0
        return cls(
            pose=pose0.expand(n, 6).clone(),
            log_weights=torch.full((n,), -math.log(float(n)), dtype=dtype,
                                   device=device),
            map_static=Gaussian2DMixture.empty((n,), config.maxFeatures,
                                               device, dtype),
            map_dynamic=Gaussian4DMixture.empty((n,), f_dynamic, device,
                                                dtype),
            resample_idx=torch.arange(n, dtype=torch.int32, device=device),
            variances=torch.zeros((n,), dtype=dtype, device=device),
        )


@dataclass
class Measurements(_TensorTree):
    """One step's padded measurements. ``count`` is the number of valid
    slots, known on the host (the runner builds it from the numpy mask), so
    the step decides whether to update without reading the device."""

    rb: torch.Tensor      # [M, 2] (range, bearing)
    label: torch.Tensor   # [M] int32
    valid: torch.Tensor   # [M] bool
    count: int

    @classmethod
    def from_numpy(cls, rb, label, valid, device=None) -> "Measurements":
        valid = np.asarray(valid, bool)
        return cls(rb=torch.as_tensor(np.asarray(rb, np.float32),
                                      device=device),
                   label=torch.as_tensor(np.asarray(label, np.int32),
                                         device=device),
                   valid=torch.as_tensor(valid, device=device),
                   count=int(valid.sum()))

    @classmethod
    def empty(cls, max_measurements: int, device=None) -> "Measurements":
        m = max_measurements
        return cls.from_numpy(np.zeros((m, 2)), np.zeros(m), np.zeros(m),
                              device)

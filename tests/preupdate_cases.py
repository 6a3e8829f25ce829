"""The pre-update's test inputs and its channel comparison, shared by
``tests/test_torch_preupdate.py`` and ``chip_smoke.py``'s pre-update phase.
Imports nothing of JAX."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from phdslam_tpu_torch import load_config
from phdslam_tpu_torch.filter.state import Gaussian2DMixture

REPO = Path(__file__).resolve().parents[1]


def random_preupdate_inputs(P, F, seed, dev):
    """(cfg, pose [P, 6], map [P, F]) on dev, seeded, with minRange 2 so
    that every range class shows: slots with w > 0, w = 0 and w < 0;
    features below 0.8 minRange, in the near bands at both ends, in range
    and beyond 1.2 maxRange; bearings inside the field of view, in its
    near band, anywhere, and within 1e-3 of +-pi of the heading (the wrap's
    fold); headings over [-3 pi, 3 pi] (the fmod); covariances from 1e-6 to
    1e4, some singular."""
    rng = np.random.default_rng(seed)
    cfg = load_config(str(REPO / "cfg/ackerman_synth.cfg")).replace(
        minRange=2.0)
    shape = (P, F)
    pose = np.zeros((P, 6))
    pose[:, :2] = rng.uniform(-20, 20, (P, 2))
    pose[:, 2] = rng.uniform(-3 * np.pi, 3 * np.pi, P)
    lo, hi = 0.8 * cfg.minRange, 1.2 * cfg.maxRange
    bands = np.array([[0.05, lo], [lo, cfg.minRange],
                      [cfg.minRange, cfg.maxRange], [cfg.maxRange, hi],
                      [hi, 4 * hi]])
    band = bands[rng.choice(len(bands), shape, p=[.1, .1, .6, .1, .1])]
    rng_ = rng.uniform(band[..., 0], band[..., 1])
    mb = cfg.maxBearing
    side = rng.choice([-1.0, 1.0], shape)
    bearing = np.choose(rng.choice(4, shape, p=[.6, .15, .15, .1]), [
        rng.uniform(-mb, mb, shape), side * rng.uniform(mb, 1.2 * mb, shape),
        rng.uniform(-np.pi, np.pi, shape),
        side * (np.pi - rng.uniform(-1e-3, 1e-3, shape))])
    heading = pose[:, None, 2] + bearing
    w = rng.uniform(1e-3, 1.0, shape) * rng.choice(
        [1.0, 0.0, -1.0], shape, p=[0.75, 0.2, 0.05])
    c00 = 10.0 ** rng.uniform(-6, 4, shape)
    c11 = 10.0 ** rng.uniform(-6, 4, shape)
    rho = np.where(rng.uniform(size=shape) < 0.05, side,
                   rng.uniform(-1, 1, shape))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    gm = Gaussian2DMixture(
        w=t(w), mx=t(pose[:, None, 0] + rng_ * np.cos(heading)),
        my=t(pose[:, None, 1] + rng_ * np.sin(heading)), c00=t(c00),
        c01=t(rho * np.sqrt(c00 * c11)), c11=t(c11))
    return cfg, t(pose), gm


def preupdate_channels_differing(kern, plain):
    """{channel: largest ulp gap} of the PreUpdate channels whose bits
    differ (a float's gap: the distance of the two as ordered integers)."""
    bad = {}
    for name, k, p in zip(kern._fields, kern, plain):
        if k.dtype != p.dtype or k.shape != p.shape:
            bad[name] = f"{k.dtype} {tuple(k.shape)} against {p.dtype} " \
                f"{tuple(p.shape)}"
            continue
        if not k.is_floating_point():
            if not torch.equal(k, p):
                bad[name] = int((k.long() - p.long()).abs().max())
            continue
        ki, pi = k.view(torch.int32).long(), p.view(torch.int32).long()
        if torch.equal(ki, pi):
            continue
        order = lambda i: torch.where(i < 0, -(i & 0x7FFFFFFF), i)
        bad[name] = int((order(ki) - order(pi)).abs().max())
    return bad

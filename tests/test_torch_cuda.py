"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided in a fixture, never at import). On a GPU machine, which has
no JAX, run them without the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

The shapes are the awkward ones chip_smoke.py does not take: F and K not
multiples of 32, odd P and cap, k1 from 1 to 8, and pools large enough
that a CTA needs more than 48 KB of dynamic shared memory. Tolerance
rtol 2e-4 / atol 1e-5, as in chip_smoke.py; at these sizes no particle
may differ.
"""

import numpy as np
import pytest
import torch

from phdslam_tpu_torch import load_config
from phdslam_tpu_torch.filter.state import Gaussian2DMixture, Measurements
from phdslam_tpu_torch.filter.state import SlamState
from phdslam_tpu_torch.filter.step import slam_step
from phdslam_tpu_torch.filter.update import kalman_preupdate
from phdslam_tpu_torch.kernels import merge as G
from phdslam_tpu_torch.kernels import select as S

pytestmark = pytest.mark.cuda

TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _select_inputs(P, F, M, seed, dev):
    rng = np.random.default_rng(seed)
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=P, maxFeatures=F, maxMeasurements=M)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    c00 = rng.uniform(0.1, 2.0, (P, F))
    c11 = rng.uniform(0.1, 2.0, (P, F))
    gm = Gaussian2DMixture(
        w=t((rng.uniform(size=(P, F)) < 0.5)
            * rng.uniform(0.05, 1.0, (P, F))),
        mx=t(rng.uniform(-2, 12, (P, F))), my=t(rng.uniform(-10, 10, (P, F))),
        c00=t(c00), c01=t(0.3 * np.sqrt(c00 * c11)
                          * rng.uniform(-1, 1, (P, F))), c11=t(c11))
    pose = t(np.concatenate([rng.normal(0, 0.3, (P, 3)), np.zeros((P, 3))],
                            1))
    z = t(np.stack([rng.uniform(0.5, 10, M), rng.uniform(-1.6, 1.6, M)], 1))
    pre = kalman_preupdate(pose, gm, cfg)
    chans = [c.contiguous() for c in S.select_channels(pre, gm)]
    return cfg, chans, z


def _assert_select_equal(kern, plain):
    live = plain[1] > 0
    torch.testing.assert_close(kern[0], plain[0], **TOL)
    torch.testing.assert_close(kern[1], plain[1], **TOL)
    for k, p in zip(kern[2:8], plain[2:8]):
        torch.testing.assert_close(k[live], p[live], **TOL)
    assert torch.equal(kern[8], plain[8])


@pytest.mark.parametrize("P,F,M,k1,raw,nv", [
    (37, 45, 11, 1, False, 11),
    (37, 45, 11, 3, True, 11),
    (64, 200, 19, 8, False, 7),
    (5, 1024, 8, 8, False, 8),      # 60 KB of shared memory per CTA
])
def test_select_kernel_matches_plain(dev, P, F, M, k1, raw, nv):
    cfg, chans, z = _select_inputs(P, F, M, P + F, dev)
    kw = dict(k1=k1, clutter_birth=float(cfg.clutterDensity
                                         + cfg.birthWeight),
              min_weight=float(cfg.minFeatureWeight),
              gate_threshold=9.0, raw=raw, with_compat=True, with_lpw=True)
    n_valid = torch.tensor([nv], dtype=torch.int32, device=dev)
    before = S.launches
    kern = S.select_cuda(chans, z, n_valid, **kw)
    assert S.launches == before + 1
    plain = S.select_plain(chans, z, n_valid, **kw)
    torch.cuda.synchronize()
    _assert_select_equal(kern, plain)
    assert not kern[1][:, nv:].any() and not kern[8][:, nv:].any()


def _pool(P, K, seed, dev):
    rng = np.random.default_rng(seed)
    w = (rng.uniform(size=(P, K)) < 0.6) * rng.uniform(0.01, 2.0, (P, K))
    w[0] = 0.0                                     # an empty row
    c00 = rng.uniform(0.05, 1.5, (P, K))
    c11 = rng.uniform(0.05, 1.5, (P, K))
    arrs = (w, rng.uniform(-20, 20, (P, K)), rng.uniform(-20, 20, (P, K)),
            c00, 0.3 * np.sqrt(c00 * c11) * rng.uniform(-1, 1, (P, K)), c11)
    return [torch.as_tensor(np.asarray(a, np.float32), device=dev)
            for a in arrs]


@pytest.mark.parametrize("P,K,cap,metric,sep", [
    (37, 97, 13, 0, 4.0),
    (37, 97, 64, 1, 0.6),
    (16, 2200, 300, 0, 5.0),        # 52.8 KB of shared memory per CTA
])
def test_merge_kernel_matches_plain(dev, P, K, cap, metric, sep):
    pool = _pool(P, K, P + K, dev)
    before = G.launches
    kern = G.merge_cuda(*pool, sep, cap, metric)
    assert G.launches == before + 1
    plain = G.merge_plain(*pool, sep, cap, metric)
    torch.cuda.synchronize()
    for k, p in zip(kern, plain):
        torch.testing.assert_close(k, p, **TOL)
    assert not kern[0][0].any() and bool((kern[3][0] == 1).all())


def test_wrappers_refuse_bad_inputs(dev):
    pool = _pool(4, 40, 0, dev)
    with pytest.raises(ValueError):
        G.merge_cuda(pool[0].t(), *pool[1:], 4.0, 8)   # not contiguous
    with pytest.raises(ValueError):
        G.merge_cuda(pool[0].double(), *pool[1:], 4.0, 8)
    cfg, chans, z = _select_inputs(4, 40, 5, 0, dev)
    with pytest.raises(ValueError):
        S.select_cuda(chans, z, torch.tensor([5], device=dev), k1=8,
                      clutter_birth=1.0, min_weight=1e-5,
                      gate_threshold=9.0)                 # int64 n_valid


def test_slam_step_cuda_matches_cpu(dev):
    """Two steps of the whole static step on the card and on the CPU, from
    the same state with the same draws."""
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=32, maxFeatures=32, maxMeasurements=16, y0=0.0,
        birthWeight=0.02)
    rng = np.random.default_rng(4)
    states = {d: SlamState.create(cfg, d) for d in ("cpu", dev)}
    for t in range(2):
        rb = np.stack([rng.uniform(0.5, 9, 16), rng.uniform(-1.4, 1.4, 16)],
                      1).astype(np.float32)
        valid = np.arange(16) < 12
        normals = torch.as_tensor(rng.normal(size=(1, 32, 2)), dtype=torch.float32)
        u = torch.as_tensor(rng.uniform(size=32), dtype=torch.float32)
        for d in states:
            z = Measurements.from_numpy(rb, np.zeros(16, np.int32), valid, d)
            states[d], _ = slam_step(states[d], (1.0, 0.05), z, 1.0, t > 0,
                                     cfg, noise=(normals.to(d), u.to(d)))
    cpu, gpu = states["cpu"], states[dev].to("cpu")
    torch.testing.assert_close(gpu.pose, cpu.pose, **TOL)
    torch.testing.assert_close(gpu.log_weights, cpu.log_weights,
                               rtol=2e-4, atol=1e-4)
    assert torch.equal(gpu.resample_idx, cpu.resample_idx)
    for name in ("w", "mx", "my", "c00", "c01", "c11"):
        torch.testing.assert_close(getattr(gpu.map_static, name),
                                   getattr(cpu.map_static, name),
                                   rtol=2e-4, atol=1e-4)

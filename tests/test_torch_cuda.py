"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided in a fixture, never at import). On a GPU machine, which has
no JAX, run them without the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

The shapes are the awkward ones chip_smoke.py does not take: F and K not
multiples of 32, odd P and cap, k1 from 1 to 8, n_valid < M, and pools
large enough that a CTA needs more than 48 KB of dynamic shared memory.
Tolerance rtol 2e-4 / atol 1e-5, as in chip_smoke.py; at these sizes no
particle may differ. Payload rows with w = 0 are don't-care (the merge
skips them) and are compared only where w > 0; indices exactly.
"""

import numpy as np
import pytest
import torch

from phdslam_tpu_torch import load_config
from phdslam_tpu_torch.filter.state import (Gaussian2DMixture,
                                            Gaussian4DMixture, Measurements)
from phdslam_tpu_torch.filter.state import SlamState
from phdslam_tpu_torch.filter.step import slam_step
from phdslam_tpu_torch.filter.update import kalman_preupdate
from phdslam_tpu_torch.filter.update4 import kalman_preupdate4
from phdslam_tpu_torch.filter import disparity as D
from phdslam_tpu_torch.kernels import esf as E
from phdslam_tpu_torch.kernels import merge as G
from phdslam_tpu_torch.kernels import merge3 as G3
from phdslam_tpu_torch.kernels import merge4 as G4
from phdslam_tpu_torch.kernels import select as S
from phdslam_tpu_torch.kernels import select4 as S4

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


@pytest.mark.parametrize("P,F,M,k1,raw,nv", [
    (37, 45, 11, 1, False, 11),
    (37, 45, 11, 3, True, 6),
    (5, 1024, 8, 8, False, 8),      # 60 KB of shared memory per CTA
])
def test_select_by_index_matches_plain(dev, P, F, M, k1, raw, nv):
    cfg, chans, z = _select_inputs(P, F, M, P + F + 1, dev)
    kw = dict(k1=k1, clutter_birth=float(cfg.clutterDensity
                                         + cfg.birthWeight),
              min_weight=float(cfg.minFeatureWeight),
              gate_threshold=9.0, raw=raw, with_compat=True, by_index=True)
    n_valid = torch.tensor([nv], dtype=torch.int32, device=dev)
    before = S.launches_by_index
    kern = S.select_cuda(chans[:S.N_LOOP], z, n_valid, **kw)
    assert S.launches_by_index == before + 1
    plain = S.select_plain(chans[:S.N_LOOP], z, n_valid, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(kern[0], plain[0], **TOL)
    torch.testing.assert_close(kern[1], plain[1], **TOL)
    assert kern[2].dtype == torch.int32 and torch.equal(kern[2], plain[2])
    assert torch.equal(kern[3], plain[3])
    # the payload kernel picks the same slots
    pay = S.select_cuda(chans, z, n_valid, **{**kw, "by_index": False})
    torch.testing.assert_close(pay[1], kern[1], rtol=0, atol=0)


def _select4_inputs(P, F, M, seed, dev):
    rng = np.random.default_rng(seed)
    cfg = load_config("cfg/mixed_synth.cfg").replace(
        n_particles=P, maxFeatures=F, maxMeasurements=M)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    a = rng.normal(size=(P, F, 4, 4)) * 0.5
    cov = a @ np.swapaxes(a, -1, -2) + 0.2 * np.eye(4)
    gm = Gaussian4DMixture(
        w=t((rng.uniform(size=(P, F)) < 0.5)
            * rng.uniform(0.05, 1.0, (P, F))),
        mean_channels=t(np.concatenate([rng.uniform(-8, 8, (P, 2, F)),
                                        rng.normal(0, 0.5, (P, 2, F))], 1)),
        cov_channels=t(np.stack([cov[..., i, j] for i in range(4)
                                 for j in range(i, 4)], 1)))
    pose = t(np.concatenate([rng.normal(0, 0.3, (P, 3)), np.zeros((P, 3))],
                            1))
    z = t(np.stack([rng.uniform(0.5, 10, M), rng.uniform(-1.6, 1.6, M)], 1))
    pre4 = kalman_preupdate4(pose, gm, cfg)
    loop, gain, mean, cov = S4.select4_channels(pre4, gm)
    return [c.contiguous() for c in loop], gain, mean, cov, z


@pytest.mark.parametrize("P,F,M,k1", [
    (37, 45, 11, 1), (37, 45, 11, 3), (64, 200, 19, 8),
    (5, 1024, 8, 8),                # 60 KB of shared memory per CTA
])
def test_select4_kernel_matches_plain(dev, P, F, M, k1):
    loop, gain, mean, cov, z = _select4_inputs(P, F, M, P + F + 2, dev)
    before = (S4.launches, S4.launches_by_index)
    kern = S4.select4_cuda(loop, gain, mean, cov, z, k1=k1)
    idx_k = S4.select4_cuda(loop, None, None, None, z, k1=k1,
                            by_index=True)
    assert (S4.launches, S4.launches_by_index) == (before[0] + 1,
                                                   before[1] + 1)
    plain = S4.select4_plain(loop, gain, mean, cov, z, k1=k1)
    idx_p = S4.select4_plain(loop, None, None, None, z, k1=k1,
                             by_index=True)
    torch.cuda.synchronize()
    live = plain[1] > 0
    assert live.any()
    torch.testing.assert_close(kern[0], plain[0], **TOL)
    torch.testing.assert_close(kern[1], plain[1], **TOL)
    for k, p in zip(kern[2:], plain[2:]):
        lv = live[:, None].expand_as(p)
        torch.testing.assert_close(k[lv], p[lv], **TOL)
    assert torch.equal(idx_k[2], idx_p[2])
    assert torch.equal(idx_k[1], kern[1]) and torch.equal(idx_k[0], kern[0])


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


def _pool4(P, K, seed, dev):
    rng = np.random.default_rng(seed)
    w = (rng.uniform(size=(P, K)) < 0.6) * rng.uniform(0.01, 2.0, (P, K))
    w[0] = 0.0                                     # an empty row
    a = rng.normal(size=(P, K, 4, 4)) * 0.5
    cov = a @ np.swapaxes(a, -1, -2) + 0.2 * np.eye(4)
    mean = np.concatenate([rng.uniform(-10, 10, (P, 2, K)),
                           rng.normal(0, 0.5, (P, 2, K))], 1)
    arrs = (w, mean, np.stack([cov[..., i, j] for i in range(4)
                               for j in range(i, 4)], 1))
    return [torch.as_tensor(np.asarray(x, np.float32), device=dev)
            for x in arrs]


@pytest.mark.parametrize("P,K,cap,sep", [
    (37, 97, 13, 5.0),
    (37, 97, 64, 1.0),
    (9, 1100, 301, 1.0),            # 66 KB of shared memory per CTA
])
def test_merge4_kernel_matches_plain(dev, P, K, cap, sep):
    pool = _pool4(P, K, P + K, dev)
    before = G4.launches
    kern = G4.merge4_cuda(*pool, sep, cap)
    assert G4.launches == before + 1
    plain = G4.merge4_plain(*pool, sep, cap)
    torch.cuda.synchronize()
    for k, p in zip(kern, plain):
        torch.testing.assert_close(k, p, **TOL)
    assert not kern[0][0].any()
    assert bool((kern[2][0, [0, 4, 7, 9]] == 1).all())


def _pool3(P, K, seed, dev):
    rng = np.random.default_rng(seed)
    w = (rng.uniform(size=(P, K)) < 0.6) * rng.uniform(0.01, 2.0, (P, K))
    w[0] = 0.0                                     # an empty row
    w[1, 3] = w[1, 7] = w[1].max()                 # an exact tie
    a = rng.normal(size=(P, K, 3, 3)) * np.array([4.0, 4.0, 20.0])[:, None]
    cov = a @ np.swapaxes(a, -1, -2) + np.diag([4.0, 4.0, 25.0])
    arrs = [w, rng.uniform(300, 400, (P, K)), rng.uniform(200, 300, (P, K)),
            rng.uniform(50, 300, (P, K))] + [cov[..., i, j]
                                             for i, j in G3.PAIRS]
    return [torch.as_tensor(np.asarray(x, np.float32), device=dev)
            for x in arrs]


@pytest.mark.parametrize("P,K,cap,sep", [
    (37, 97, 13, 4.0),
    (37, 97, 64, 16.0),
    (3, 496, 64, 4.0),              # the shipped disparity pool
    (5, 1500, 200, 4.0),            # 60 KB of shared memory per CTA
])
def test_merge3_kernel_matches_plain(dev, P, K, cap, sep):
    pool = _pool3(P, K, P + K, dev)
    before = G3.launches
    kern = G3.merge3_cuda(*pool, sep, cap)
    assert G3.launches == before + 1
    plain = G3.merge3_plain(*pool, sep, cap)
    torch.cuda.synchronize()
    for k, p in zip(kern, plain):
        torch.testing.assert_close(k, p, rtol=2e-4, atol=1e-3)
    assert not kern[0][0].any()
    assert bool((kern[4][0] == 1).all()) and bool((kern[9][0] == 1).all())


@pytest.mark.parametrize("P,M,n_pad", [
    (7, 1, 0), (5, 2, 1), (33, 13, 4), (3, 64, 0),
    (2, 256, 17),                   # 67 KB of shared memory per CTA
])
def test_esf_kernel_matches_plain(dev, P, M, n_pad):
    """Finite entries within tolerance, the sentinel (below -1e29) in the
    same places; no NaN anywhere."""
    rng = np.random.default_rng(P + M)
    ll = rng.uniform(-6.0, 3.0, (P, M)).astype(np.float32)
    if n_pad:
        ll[:, M - n_pad:] = -np.inf
    ll = torch.as_tensor(ll, device=dev)
    before = E.launches
    kern = E.esf_all_cuda(ll)
    assert E.launches == before + 1
    plain = E.esf_all_plain(ll)
    torch.cuda.synchronize()
    for k, p in zip(kern, plain):
        assert not torch.isnan(k).any()
        live = p > -1e29
        assert torch.equal(k > -1e29, live)
        torch.testing.assert_close(k[live], p[live], **TOL)


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
    n5 = torch.tensor([5], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                       # 16 channels
        S.select_cuda(chans, z, n5, k1=8, clutter_birth=1.0,
                      min_weight=1e-5, gate_threshold=9.0, by_index=True)
    loop, gain, mean, cov, z4 = _select4_inputs(4, 40, 5, 0, dev)
    with pytest.raises(ValueError):
        S4.select4_cuda(loop, gain[:, :4], mean, cov, z4, k1=8)
    with pytest.raises(ValueError):
        S4.select4_cuda(loop, gain, mean, cov, z4.cpu(), k1=8)
    with pytest.raises(ValueError):
        S4.select4_cuda(loop, gain, mean, cov, z4, k1=33)
    w, mean4, cov4 = _pool4(4, 40, 0, dev)
    with pytest.raises(ValueError):
        G4.merge4_cuda(w, mean4.transpose(1, 2), cov4, 1.0, 8)
    with pytest.raises(ValueError):
        G4.merge4_cuda(w, mean4, cov4.double(), 1.0, 8)
    with pytest.raises(RuntimeError):     # 15 x 4000 floats: 240 KB
        G4.merge4_cuda(*_pool4(2, 4000, 0, dev), 1.0, 8)
    pool3 = _pool3(4, 40, 0, dev)
    with pytest.raises(ValueError):
        G3.merge3_cuda(*pool3[:9], pool3[9].double(), 4.0, 8)
    with pytest.raises(RuntimeError):     # 10 x 6000 floats: 240 KB
        G3.merge3_cuda(*_pool3(2, 6000, 0, dev), 4.0, 8)
    with pytest.raises(ValueError):
        E.esf_all_cuda(torch.zeros((4, 6), device=dev).t())


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


def test_mixed_slam_step_cuda_matches_cpu(dev):
    """Two steps of the mixed static + dynamic step on the card and on the
    CPU, from the same state with the same draws."""
    cfg = load_config("cfg/mixed_synth.cfg").replace(
        n_particles=32, maxFeatures=32, maxMeasurements=16, y0=0.0)
    rng = np.random.default_rng(5)
    states = {d: SlamState.create(cfg, d) for d in ("cpu", dev)}
    for t in range(2):
        rb = np.stack([rng.uniform(0.5, 9, 16), rng.uniform(-1.4, 1.4, 16)],
                      1).astype(np.float32)
        valid = np.arange(16) < 12
        normals = torch.as_tensor(rng.normal(size=(1, 32, 2)),
                                  dtype=torch.float32)
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
    for name in ("w", "mean_channels", "cov_channels"):
        torch.testing.assert_close(getattr(gpu.map_dynamic, name),
                                   getattr(cpu.map_dynamic, name),
                                   rtol=2e-4, atol=1e-4)
    assert float(cpu.map_dynamic.w.sum()) > 0


def test_cphd_slam_step_cuda_matches_cpu(dev):
    """Three CPHD steps (births from the previous measurements from the
    second on) on the card and on the CPU, from the same state with the
    same draws."""
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=32, maxFeatures=32, maxMeasurements=16, y0=0.0,
        birthWeight=0.02, filterType=1, maxCardinality=63)
    rng = np.random.default_rng(6)
    states = {d: SlamState.create(cfg, d) for d in ("cpu", dev)}
    prev = {d: None for d in states}
    for t in range(3):
        rb = np.stack([rng.uniform(0.5, 9, 16), rng.uniform(-1.4, 1.4, 16)],
                      1).astype(np.float32)
        valid = np.arange(16) < 12
        normals = torch.as_tensor(rng.normal(size=(1, 32, 2)),
                                  dtype=torch.float32)
        u = torch.as_tensor(rng.uniform(size=32), dtype=torch.float32)
        for d in states:
            z = Measurements.from_numpy(rb, np.zeros(16, np.int32), valid, d)
            states[d], _ = slam_step(states[d], (1.0, 0.05), z, 1.0, t > 0,
                                     cfg, noise=(normals.to(d), u.to(d)),
                                     z_prev=prev[d])
            prev[d] = z
    cpu, gpu = states["cpu"], states[dev].to("cpu")
    torch.testing.assert_close(gpu.pose, cpu.pose, **TOL)
    torch.testing.assert_close(gpu.log_weights, cpu.log_weights,
                               rtol=2e-4, atol=1e-3)
    assert torch.equal(gpu.resample_idx, cpu.resample_idx)
    live = cpu.cardinality > -1e30
    assert torch.equal(gpu.cardinality > -1e30, live)
    torch.testing.assert_close(gpu.cardinality[live], cpu.cardinality[live],
                               rtol=2e-4, atol=1e-3)
    for name in ("w", "mx", "my", "c00", "c01", "c11"):
        torch.testing.assert_close(getattr(gpu.map_static, name),
                                   getattr(cpu.map_static, name),
                                   rtol=2e-4, atol=1e-4)


def test_disparity_step_cuda_matches_cpu(dev):
    """Two disparity steps at the shipped widths on the card and on the
    CPU, from the same state with the same draws."""
    cfg = load_config("cfg/disparity_synth.cfg").replace(n_particles=16)
    rng = np.random.default_rng(8)
    base = D.DisparityState.create(cfg)
    P, F, npp = base.px.shape
    states = {d: base.to(d) for d in ("cpu", dev)}
    M = cfg.maxMeasurements
    for t in range(2):
        uv = np.stack([rng.uniform(20, 780, M), rng.uniform(20, 580, M)],
                      1).astype(np.float32)
        valid = np.arange(M) < 30
        noise = (torch.as_tensor(rng.normal(size=(P, 6)), dtype=torch.float32),
                 torch.as_tensor(rng.normal(size=(P, F, npp, 3)),
                                 dtype=torch.float32),
                 torch.as_tensor(rng.uniform(size=P), dtype=torch.float32))
        for d in states:
            z = Measurements.from_numpy(uv, np.zeros(M, np.int32), valid, d)
            states[d], _ = D.disparity_step(
                states[d], z, 1.0, t > 0, cfg,
                noise=tuple(x.to(d) for x in noise))
    cpu, gpu = states["cpu"], states[dev].to("cpu")
    torch.testing.assert_close(gpu.pose, cpu.pose, **TOL)
    torch.testing.assert_close(gpu.log_weights, cpu.log_weights,
                               rtol=2e-4, atol=1e-4)
    assert torch.equal(gpu.resample_idx, cpu.resample_idx)
    torch.testing.assert_close(gpu.w, cpu.w, rtol=2e-4, atol=1e-5)
    for name in ("px", "py", "pz"):
        torch.testing.assert_close(getattr(gpu, name), getattr(cpu, name),
                                   rtol=2e-4, atol=1e-3)
    assert float(cpu.w.sum()) > 0

"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided in a fixture, never at import). On a GPU machine, which has
no JAX, run them without the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

The shapes are the awkward ones chip_smoke.py does not take: F and K not
multiples of 32, odd P and cap, k1 from 1 to 8, n_valid < M, pools large
enough that a CTA needs more than 48 KB of dynamic shared memory, and rows
and pools past what a CTA holds (select F > 1024, merge K > 7744, merge4 K
> 3520, merge3 K > 5051), which run the kernels' device-memory paths.
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


def _edit_select(chans, kind):
    """kind "dead": every slot of particle 0 out of range (lpw = -1e30, so
    e = 0 and the rounds exit at once), half of particle 1's; "dup": the
    second half of every row a copy of the first, so each value occurs
    twice (exact ties in v, the lower slot first); None: as given."""
    chans = [c.clone() for c in chans]
    F = chans[0].shape[1]
    if kind == "dead":
        chans[2][0] = S.NEG_LARGE
        chans[2][1, ::2] = S.NEG_LARGE
    elif kind == "dup":
        h = F // 2
        for c in chans:
            c[:, F - h:] = c[:, :h]
    return chans


@pytest.mark.parametrize("P,F,M,k1,raw,nv,kind", [
    (9, 511, 12, 8, False, 12, "dead"),   # the register rows' edges
    (9, 512, 12, 8, True, 12, "dup"),
    (9, 513, 12, 32, False, 12, "dup"),
    (9, 512, 12, 32, True, 5, "dead"),
    (9, 64, 12, 8, False, 0, None),       # n_valid = 0
    (9, 1024, 8, 32, False, 8, "dup"),    # the widest row
    (9, 33, 12, 32, True, 12, "dup"),     # k1 above the live slots
])
def test_select_kernel_edges(dev, P, F, M, k1, raw, nv, kind):
    """The payload and by-index kernels at the row sizes' edges, k1 = 32,
    n_valid = 0, dead rows and exact ties, against the plain version."""
    cfg, chans, z = _select_inputs(P, F, M, P + F + 5, dev)
    chans = _edit_select(chans, kind)
    kw = dict(k1=k1, clutter_birth=float(cfg.clutterDensity
                                         + cfg.birthWeight),
              min_weight=float(cfg.minFeatureWeight),
              gate_threshold=9.0, raw=raw, with_compat=True, with_lpw=True)
    n_valid = torch.tensor([nv], dtype=torch.int32, device=dev)
    kern = S.select_cuda(chans, z, n_valid, **kw)
    plain = S.select_plain(chans, z, n_valid, **kw)
    kwb = dict(kw, by_index=True)
    del kwb["with_lpw"]
    idx_k = S.select_cuda(chans[:S.N_LOOP], z, n_valid, **kwb)
    idx_p = S.select_plain(chans[:S.N_LOOP], z, n_valid, **kwb)
    torch.cuda.synchronize()
    _assert_select_equal(kern, plain)
    assert torch.equal(idx_k[2], idx_p[2]) and torch.equal(idx_k[1], kern[1])
    assert not kern[1][:, nv:].any() and not kern[8][:, nv:].any()
    if kind == "dead":
        assert not kern[1][0].any() and not idx_k[2][0].any()
    if kind == "dup" and nv:
        assert bool((kern[1][:, :nv, 0] == kern[1][:, :nv, 1]).any())


@pytest.mark.parametrize("P,F,M,k1,kind", [
    (9, 511, 12, 8, "dead"), (9, 512, 12, 8, "dup"),
    (9, 513, 12, 32, "dup"), (5, 1024, 8, 32, "dead"),
])
def test_select4_kernel_edges(dev, P, F, M, k1, kind):
    loop, gain, mean, cov, z = _select4_inputs(P, F, M, P + F + 6, dev)
    loop = _edit_select(loop, kind)
    if kind == "dup":
        h = F // 2
        gain, mean, cov = (t.clone() for t in (gain, mean, cov))
        for t in (gain, mean, cov):
            t[..., F - h:] = t[..., :h]
    kern = S4.select4_cuda(loop, gain, mean, cov, z, k1=k1)
    plain = S4.select4_plain(loop, gain, mean, cov, z, k1=k1)
    idx_k = S4.select4_cuda(loop, None, None, None, z, k1=k1, by_index=True)
    idx_p = S4.select4_plain(loop, None, None, None, z, k1=k1,
                             by_index=True)
    torch.cuda.synchronize()
    live = plain[1] > 0
    torch.testing.assert_close(kern[0], plain[0], **TOL)
    torch.testing.assert_close(kern[1], plain[1], **TOL)
    for k, p in zip(kern[2:], plain[2:]):
        lv = live[:, None].expand_as(p)
        torch.testing.assert_close(k[lv], p[lv], **TOL)
    assert torch.equal(idx_k[2], idx_p[2]) and torch.equal(idx_k[1], kern[1])
    if kind == "dead":
        assert not kern[1][0].any()


def test_select_kernels_take_no_index_past_the_row_on_nan(dev):
    """A NaN lds row (particle 0) and NaN slots (particle 1): every index
    the kernels return is < F and every weight 0 or finite, in raw and
    normalised mode and in select4; the payload fetch stays in the row."""
    P, F, M = 6, 200, 10
    cfg, chans, z = _select_inputs(P, F, M, 21, dev)
    chans = [c.clone() for c in chans]
    chans[6][0] = float("nan")
    chans[6][1, ::7] = float("nan")
    n_valid = torch.tensor([M], dtype=torch.int32, device=dev)
    for raw in (False, True):
        kw = dict(k1=8, clutter_birth=1.0, min_weight=1e-5,
                  gate_threshold=9.0, raw=raw)
        pay = S.select_cuda(chans, z, n_valid, **kw)
        _, w, idx, _ = S.select_cuda(chans[:S.N_LOOP], z, n_valid,
                                     **kw, by_index=True)
        torch.cuda.synchronize()
        for ww in (w, pay[1]):
            assert bool((torch.isfinite(ww) | (ww == 0)).all())
        assert bool(((idx >= 0) & (idx < F)).all())
        assert torch.equal(pay[1], w)
    loop, gain, mean, cov, z4 = _select4_inputs(P, F, M, 22, dev)
    loop = [c.clone() for c in loop]
    loop[6][0] = float("nan")
    out = S4.select4_cuda(loop, gain, mean, cov, z4, k1=8)
    _, w4, idx4 = S4.select4_cuda(loop, None, None, None, z4, k1=8,
                                  by_index=True)
    torch.cuda.synchronize()
    assert bool((torch.isfinite(w4) | (w4 == 0)).all())
    assert bool(((idx4 >= 0) & (idx4 < F)).all()) and not w4[0].any()
    assert torch.equal(out[1], w4)


def test_select_kernel_wraps_bearings_as_the_plain_version(dev):
    """Raw picks of rows whose bearing innovations sit at and around the
    half-turns (x / 2pi within a few ulps of a half-integer, |x| up to
    40 pi), where the wrap decides between +pi and -pi, and on random
    values: ir = 1 and si01 = 0.5 make the sign count (the two terms differ
    by a factor e^pi). F = 32 and k1 = 32, so every term is a pick; the
    picks' order is not compared (many terms are equal up to rounding)."""
    P, F, M = 64, 32, 3
    rng = np.random.default_rng(9)
    x = ((rng.integers(-20, 20, (P, F)) + 0.5) * 2 * np.pi
         * (1 + rng.integers(-8, 9, (P, F)) * 2.0 ** -24))
    x[::2] = rng.uniform(-4 * np.pi, 4 * np.pi, (P // 2, F))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    one = np.ones((P, F))
    # z = (3, 0): ir = 1 and the innovation zb - b = x exactly
    chans = [t(2 * one), t(-x.astype(np.float32)), t(0 * one), t(one),
             t(0.5 * one), t(0.05 * one), t(0 * one)]
    z = t([[3.0, 0.0]] * M)
    n_valid = torch.tensor([M], dtype=torch.int32, device=dev)
    kw = dict(k1=32, clutter_birth=1.0, min_weight=1e-5, gate_threshold=9.0,
              raw=True, by_index=True)
    kern = S.select_cuda(chans, z, n_valid, **kw)
    plain = S.select_plain(chans, z, n_valid, **kw)
    torch.cuda.synchronize()
    # every term is in the sum: a wrap to the other side of a half-turn
    # would move it by far more than the tolerance
    torch.testing.assert_close(kern[0], plain[0], **TOL)
    torch.testing.assert_close(kern[1], plain[1], **TOL)


def test_select_kernels_occupancy_and_row_limit(dev):
    """Every row size has a kernel that fits on an SM: the register rows up
    to 1024 slots, the wide-row kernel above, which takes scratch rows and
    agrees with the plain version at F = 1025 (no refusal)."""
    import ctypes
    from phdslam_tpu_torch.kernels import _build
    lib, _ = _build.library()
    regs = ctypes.c_int(0)
    for F in (1, 32, 33, 128, 512, 513, 1024, 1025, 4096, 100000):
        assert lib.phd_select_ctas_per_sm(F, ctypes.byref(regs)) >= 1
        assert 0 < regs.value <= 255
        assert lib.phd_select4_ctas_per_sm(F, ctypes.byref(regs)) >= 1
    assert lib.phd_select_wide_floats(2, 1024) == 0
    assert lib.phd_select_wide_floats(2, 1025) > 0
    cfg, chans, z = _select_inputs(2, 1025, 4, 0, dev)
    n4 = torch.tensor([4], dtype=torch.int32, device=dev)
    kw = dict(k1=8, clutter_birth=1.0, min_weight=1e-5, gate_threshold=9.0)
    kern = S.select_cuda(chans, z, n4, **kw)
    _assert_select_equal(kern, S.select_plain(chans, z, n4, **kw))


@pytest.mark.parametrize("P,F,M,k1,raw,nv,kind", [
    (5, 1025, 8, 8, False, 8, None),      # one past the register rows
    (5, 1025, 8, 32, True, 6, "dup"),
    (3, 4096, 8, 8, False, 8, "dead"),
    (3, 4096, 6, 8, True, 6, None),
])
def test_select_wide_rows_match_plain(dev, P, F, M, k1, raw, nv, kind):
    """Rows wider than 1024 slots (the wide-row kernel, values in scratch)
    in both modes of select and select4, against the plain versions:
    values within tolerance, indices exactly, the by-index picks the
    payload kernel's."""
    cfg, chans, z = _select_inputs(P, F, M, P + F + 11, dev)
    chans = _edit_select(chans, kind)
    kw = dict(k1=k1, clutter_birth=float(cfg.clutterDensity
                                         + cfg.birthWeight),
              min_weight=float(cfg.minFeatureWeight),
              gate_threshold=9.0, raw=raw, with_compat=True, with_lpw=True)
    n_valid = torch.tensor([nv], dtype=torch.int32, device=dev)
    before = (S.launches, S.launches_by_index)
    kern = S.select_cuda(chans, z, n_valid, **kw)
    kwb = dict(kw, by_index=True)
    del kwb["with_lpw"]
    idx_k = S.select_cuda(chans[:S.N_LOOP], z, n_valid, **kwb)
    assert (S.launches, S.launches_by_index) == (before[0] + 1,
                                                 before[1] + 1)
    plain = S.select_plain(chans, z, n_valid, **kw)
    idx_p = S.select_plain(chans[:S.N_LOOP], z, n_valid, **kwb)
    torch.cuda.synchronize()
    _assert_select_equal(kern, plain)
    assert torch.equal(idx_k[2], idx_p[2]) and torch.equal(idx_k[1], kern[1])
    assert not kern[1][:, nv:].any() and not kern[8][:, nv:].any()
    if kind == "dead":
        assert not kern[1][0].any()
    loop, gain, mean, cov, z4 = _select4_inputs(P, F, M, P + F + 12, dev)
    loop = _edit_select(loop, kind)
    k4 = S4.select4_cuda(loop, gain, mean, cov, z4, k1=k1)
    i4 = S4.select4_cuda(loop, None, None, None, z4, k1=k1, by_index=True)
    p4 = S4.select4_plain(loop, gain, mean, cov, z4, k1=k1)
    q4 = S4.select4_plain(loop, None, None, None, z4, k1=k1, by_index=True)
    torch.cuda.synchronize()
    live = p4[1] > 0
    torch.testing.assert_close(k4[0], p4[0], **TOL)
    torch.testing.assert_close(k4[1], p4[1], **TOL)
    for k, q in zip(k4[2:], p4[2:]):
        lv = live[:, None].expand_as(q)
        torch.testing.assert_close(k[lv], q[lv], **TOL)
    assert torch.equal(i4[2], q4[2]) and torch.equal(i4[1], k4[1])


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


def _per_run_z(z, R, seed, dev):
    """R measurement sets [R, M, 2]: z, then R - 1 others of its range."""
    rng = np.random.default_rng(seed)
    M = z.shape[0]
    other = np.stack([rng.uniform(0.5, 10, (R - 1, M)),
                      rng.uniform(-1.6, 1.6, (R - 1, M))], -1)
    return torch.cat([z[None], torch.as_tensor(other, dtype=torch.float32,
                                               device=dev)]).contiguous()


@pytest.mark.parametrize("P,F,M,k1,raw", [
    (3 * 37, 45, 11, 3, False),
    (4 * 16, 200, 19, 8, True),
    (3 * 2, 1025, 8, 8, False),     # the wide-row kernel
])
def test_select_kernels_per_run_sets_match_single_runs(dev, P, F, M, k1,
                                                       raw):
    """R runs blockwise, each with its own measurement set (and, for
    select, its own n_valid): one launch of each kernel, both modes,
    equals R single-run launches on the particle slices bit for bit, and
    the plain version on the same per-run inputs within tolerance."""
    R = 3 if P % 3 == 0 else 4
    n = P // R
    cfg, chans, z1 = _select_inputs(P, F, M, P + F + 21, dev)
    z = _per_run_z(z1, R, P + F, dev)
    nv = torch.tensor([M, M - 3, 0, 1][:R], dtype=torch.int32, device=dev)
    kw = dict(k1=k1, clutter_birth=float(cfg.clutterDensity
                                         + cfg.birthWeight),
              min_weight=float(cfg.minFeatureWeight),
              gate_threshold=9.0, raw=raw, with_compat=True, with_lpw=True)
    kwb = dict(kw, by_index=True)
    del kwb["with_lpw"]
    loop, gain, mean, cov, _ = _select4_inputs(P, F, M, P + F + 22, dev)
    runs = dict(
        select=(lambda zz, v, sl: S.select_cuda([c[sl] for c in chans], zz,
                                                v, **kw)),
        by_index=(lambda zz, v, sl: S.select_cuda(
            [c[sl] for c in chans[:S.N_LOOP]], zz, v, **kwb)),
        select4=(lambda zz, v, sl: S4.select4_cuda(
            [c[sl] for c in loop], gain[sl].contiguous(),
            mean[sl].contiguous(), cov[sl].contiguous(), zz, k1=k1)),
        select4_by_index=(lambda zz, v, sl: S4.select4_cuda(
            [c[sl] for c in loop], None, None, None, zz, k1=k1,
            by_index=True)))
    for name, run in runs.items():
        before = (S.launches, S.launches_by_index, S4.launches,
                  S4.launches_by_index)
        got = run(z, nv, slice(None))
        after = (S.launches, S.launches_by_index, S4.launches,
                 S4.launches_by_index)
        assert sum(after) == sum(before) + 1, name
        for r in range(R):
            sl = slice(r * n, (r + 1) * n)
            one = run(z[r].contiguous(), nv[r:r + 1].contiguous(), sl)
            for g, o in zip(got, one):
                assert torch.equal(g[sl], o), (name, r)
    plain = S.select_plain(chans, z, nv, **kw)
    _assert_select_equal(S.select_cuda(chans, z, nv, **kw), plain)
    assert not plain[1][2 * n:3 * n].any()          # run 2: n_valid 0
    p4 = S4.select4_plain(loop, gain, mean, cov, z, k1=k1)
    k4 = S4.select4_cuda(loop, gain, mean, cov, z, k1=k1)
    torch.cuda.synchronize()
    torch.testing.assert_close(k4[0], p4[0], **TOL)
    live = p4[1] > 0
    for k, q in zip(k4[2:], p4[2:]):
        lv = live[:, None].expand_as(q)
        torch.testing.assert_close(k[lv], q[lv], **TOL)


def test_select_kernels_refuse_sets_that_do_not_split_the_particles(dev):
    cfg, chans, z1 = _select_inputs(10, 40, 5, 0, dev)
    z = _per_run_z(z1, 3, 1, dev)
    nv = torch.tensor([5, 5, 5], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                 # 3 sets, 10 particles
        S.select_cuda(chans, z, nv, k1=8, clutter_birth=1.0,
                      min_weight=1e-5, gate_threshold=9.0)
    with pytest.raises(ValueError):                 # 2 counts for 3 sets
        S.select_cuda([c[:9] for c in chans], z, nv[:2], k1=8,
                      clutter_birth=1.0, min_weight=1e-5, gate_threshold=9.0)


def test_batched_slam_step_cuda_matches_single_runs(dev):
    """Two steps of R = 3 static runs in one batched step on the card
    against each run stepped alone on the card, from the same states and
    draws: the log-likelihoods within 1e-5 relative, the same resample
    picks."""
    R, n, M = 3, 64, 16
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=n, maxFeatures=32, maxMeasurements=M, y0=0.0,
        birthWeight=0.02, resampleThresh=2.0)
    rng = np.random.default_rng(9)
    batch = SlamState.create(cfg, dev, n_runs=R)
    alone = [SlamState.create(cfg, dev) for _ in range(R)]
    for t in range(2):
        rb = np.stack([rng.uniform(0.5, 9, (R, M)),
                       rng.uniform(-1.4, 1.4, (R, M))], -1).astype(np.float32)
        valid = np.arange(M)[None, :] < np.array([[12], [16], [3]])
        normals = torch.as_tensor(rng.normal(size=(1, R * n, 2)),
                                  dtype=torch.float32, device=dev)
        u = torch.as_tensor(rng.uniform(size=R * n), dtype=torch.float32,
                            device=dev)
        ctrl = torch.tensor([1.0, 0.8, 1.2], device=dev)
        z = Measurements.from_numpy(rb, np.zeros((R, M), np.int32), valid,
                                    dev)
        batch, aux = slam_step(batch, (ctrl, ctrl * 0.05), z, 1.0, t > 0, cfg,
                               noise=(normals, u))
        for r in range(R):
            sl = slice(r * n, (r + 1) * n)
            zr = Measurements.from_numpy(rb[r], np.zeros(M, np.int32),
                                         valid[r], dev)
            alone[r], aux1 = slam_step(
                alone[r], (float(ctrl[r]), float(ctrl[r] * 0.05)), zr, 1.0,
                t > 0, cfg, noise=(normals[:, sl], u[sl]))
            torch.testing.assert_close(aux.log_lik[r], aux1.log_lik,
                                       rtol=1e-5, atol=0)
            assert torch.equal(batch.resample_idx[sl], alone[r].resample_idx)
            torch.testing.assert_close(batch.pose[sl], alone[r].pose, **TOL)


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
    (16, 2200, 300, 0, 5.0),        # 66 KB of shared memory per CTA
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


def _edge_weights(w):
    """Row 0 keeps no live weight; row 1 is <= 0 everywhere but one
    candidate; row 2 has an exact three-way tie at the top (the lowest
    index is picked first); row 3 takes a few weight values only, ties
    throughout."""
    w = w.clone()
    K = w.shape[1]
    w[1] = -torch.linspace(0.0, 1.0, K, device=w.device)
    w[1, K // 2] = 0.5
    w[2, [3, 7, 11]] = 2.5
    w[3] = torch.where(w[3] > 0, torch.round(w[3] * 2) / 2 + 0.5, w[3])
    return w


@pytest.mark.parametrize("P,K,cap,metric,sep", [
    (9, 97, 5, 0, 4.0),             # cap reached before the weight runs out
    (9, 97, 200, 0, 4.0),           # the weight runs out before cap
    (9, 97, 200, 1, 0.6),
    (4, 7609, 300, 0, 5.0),         # the gated chain's widest K
    (4, 7610, 300, 0, 5.0),         # pick_loop in shared memory from here
    (4, 7744, 300, 0, 5.0),         # the widest K: 227 KB of shared memory
])
def test_merge_kernel_edge_pools(dev, P, K, cap, metric, sep):
    """Ties, dead rows, both ends of the pick loop and the widest pool,
    against the plain version; two launches give the same bits."""
    pool = _pool(P, K, P + K + 3, dev)
    pool[0] = _edge_weights(pool[0])
    kern = G.merge_cuda(*pool, sep, cap, metric)
    again = G.merge_cuda(*pool, sep, cap, metric)
    plain = G.merge_plain(*pool, sep, cap, metric)
    torch.cuda.synchronize()
    for k, a, p in zip(kern, again, plain):
        assert torch.equal(k, a)
        torch.testing.assert_close(k, p, **TOL)
    n_live = (kern[0] > 0).sum(1)
    assert n_live[0] == 0 and n_live[1] == 1
    if cap < 10:
        assert bool((n_live == cap).any())
    if cap >= K:
        assert bool((n_live < cap).all())


@pytest.mark.parametrize("kind,P,K,cap,metric,sep", [
    ("course", 6, 1088, 512, 0, 5.0),
    ("chain", 6, 400, 300, 0, 5.0),
    ("outliers", 6, 500, 200, 0, 5.0),
    ("outliers", 6, 500, 200, 1, 0.6),
    ("random", 6, 7609, 300, 0, 5.0),   # the gated chain's widest pool
    ("random", 6, 7610, 300, 0, 5.0),   # pick_loop in shared memory
    ("random", 6, 7745, 300, 0, 5.0),   # the device-memory pool
])
def test_merge_kernel_counts_its_chain(dev, kind, P, K, cap, metric, sep):
    """The stats pointer: the kernel's batches, exact tests, unbounded and
    live candidates and slots are gated_owners' (tests/merge_pools.py's
    pools), the gate tests at least the exact ones; where the pool leaves
    no room for the gated chain's tables (K > 7609), pick_loop runs and
    the four chain counts read -1. A launch with stats writes the outputs
    of one without."""
    import merge_pools as MP
    pool = [torch.as_tensor(a, device=dev) for a in MP.POOLS[kind](P, K, K)]
    stats = torch.zeros((P, len(G.STATS)), dtype=torch.int32, device=dev)
    kern = G.merge_cuda(*pool, sep, cap, metric, stats=stats)
    plain = G.merge_cuda(*pool, sep, cap, metric)
    want = G.gated_owners(*(a.cpu() for a in pool), sep, cap, metric)[2]
    torch.cuda.synchronize()
    for k, p in zip(kern, plain):
        assert torch.equal(k.view(torch.int32), p.view(torch.int32))
    got = stats.cpu().long()
    col = lambda t, name: t[:, G.STATS.index(name)]
    for name in ("live", "slots"):
        assert torch.equal(col(got, name), col(want, name)), name
    for name in ("batches", "gate_tests", "exact_tests", "unbounded"):
        if K > 7609:                    # pick_loop ran
            assert bool((col(got, name) == -1).all()), name
        elif name != "gate_tests":
            assert torch.equal(col(got, name), col(want, name)), name
    assert bool((col(got, "gate_tests") >= col(got, "exact_tests")).all())


def _degenerate_cov4(cov, seed):
    """cov with a quarter of the candidates zero, a quarter singular (rank
    1) and a quarter slightly indefinite (rank 1 minus 1e-3 I): the clamps
    of the Cholesky bind."""
    rng = np.random.default_rng(seed)
    P, _, K = cov.shape
    u = rng.normal(size=(4, P, K))
    rank1 = np.stack([u[i] * u[j] for i in range(4) for j in range(i, 4)], 1)
    diag = np.zeros((1, 10, 1))
    diag[0, [0, 4, 7, 9], 0] = 1e-3
    kind = rng.integers(0, 4, (P, 1, K))
    alt = np.where(kind == 0, 0.0, np.where(kind == 1, rank1, rank1 - diag))
    alt = torch.as_tensor(alt.astype(np.float32), device=cov.device)
    return torch.where(torch.as_tensor(kind < 3, device=cov.device), alt,
                       cov)


@pytest.mark.parametrize("P,K,cap,sep,degenerate", [
    (9, 97, 5, 1.0, False),         # cap reached before the weight runs out
    (9, 97, 200, 1.0, False),       # the weight runs out before cap
    (9, 97, 200, 1.0, True),
    (9, 300, 300, 5.0, True),
    (4, 3520, 200, 1.0, False),     # the widest K: 227 KB of shared memory
])
def test_merge4_kernel_edge_pools(dev, P, K, cap, sep, degenerate):
    """Ties, dead rows, both ends of the pick loop, the widest pool, and
    covariances where the clamps bind (so that the early exit must decide
    as the full test does), against the plain version; two launches give
    the same bits."""
    w, mean, cov = _pool4(P, K, P + K + 4, dev)
    w = _edge_weights(w)
    if degenerate:
        mean = mean * 0.3               # close enough for full tests
        cov = _degenerate_cov4(cov, P + K)
    kern = G4.merge4_cuda(w, mean, cov, sep, cap)
    again = G4.merge4_cuda(w, mean, cov, sep, cap)
    plain = G4.merge4_plain(w, mean, cov, sep, cap)
    torch.cuda.synchronize()
    for k, a, p in zip(kern, again, plain):
        assert torch.equal(k, a)
        torch.testing.assert_close(k, p, **TOL)
    n_live = (kern[0] > 0).sum(1)
    assert n_live[0] == 0 and n_live[1] == 1
    if cap < 10:
        assert bool((n_live == cap).any())
    if cap >= K:
        assert bool((n_live < cap).all())


def test_merge4_reject_scale_is_the_kernels(dev):
    """kernels/merge4.py::reject_scale, which tests/test_torch_update4.py
    proves exact, is the k0 that csrc/merge4.cu computes on the card, bit
    for bit: the CPU tests' min_sep values, those out of range and 4096
    log-uniform ones from 1e-30 to 1e30."""
    from phdslam_tpu_torch.kernels import _build
    rng = np.random.default_rng(4)
    seps = [1.0, 5.0, 0.37, 9.0, 123.456, 1e-20, 0.0, -1.0, float("nan"),
            3.1e38, float("inf")] + [
        float(x) for x in np.float32(10.0) ** rng.uniform(-30, 30, 4096)
        .astype(np.float32)]
    x = torch.tensor(seps, dtype=torch.float32, device=dev)
    k0 = torch.empty(len(seps), dtype=torch.float64, device=dev)
    lib, _ = _build.library()
    _build.check(lib, lib.phd_merge4_reject_scale(
        x.data_ptr(), k0.data_ptr(), len(seps),
        torch.cuda.current_stream(dev).cuda_stream), "reject_scale")
    want = [G4.reject_scale(float(s)) for s in x.cpu().tolist()]
    assert k0.cpu().tolist() == want


def test_merge_kernels_refuse_one_past_the_widest_pool(dev):
    """The widest pools in shared memory take no scratch; one past each
    takes a device-memory pool and runs, where the merges once refused."""
    from phdslam_tpu_torch.kernels import _build
    lib, _ = _build.library()
    for fn, widest in ((lib.phd_merge_wide_floats, 7744),
                       (lib.phd_merge4_wide_floats, 3520),
                       (lib.phd_merge3_wide_floats, 5051)):
        assert fn(2, widest) == 0 and fn(2, widest + 1) > 0
    for k, p in zip(G.merge_cuda(*_pool(2, 7745, 0, dev), 5.0, 8),
                    G.merge_plain(*_pool(2, 7745, 0, dev), 5.0, 8)):
        torch.testing.assert_close(k, p, **TOL)
    for k, p in zip(G4.merge4_cuda(*_pool4(2, 3521, 0, dev), 1.0, 8),
                    G4.merge4_plain(*_pool4(2, 3521, 0, dev), 1.0, 8)):
        torch.testing.assert_close(k, p, **TOL)
    for k, p in zip(G3.merge3_cuda(*_pool3(2, 5052, 0, dev), 4.0, 8),
                    G3.merge3_plain(*_pool3(2, 5052, 0, dev), 4.0, 8)):
        torch.testing.assert_close(k, p, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("which,K,cap", [
    ("merge", 7745, 300), ("merge", 16384, 300), ("merge metric 1", 7745,
                                                 200),
    ("merge4", 3521, 300), ("merge4", 8192, 200),
    ("merge3", 5052, 200), ("merge3", 10240, 200),
])
def test_merge_wide_pools_match_plain(dev, which, K, cap):
    """Pools too wide for a CTA's shared memory (the device-memory path,
    the CTAs striding over 1030 particles, more than the 1024 CTAs the path
    launches, of which only the first 6 and the last hold candidates), with
    the edge weights (dead row, lone candidate, ties), against the plain
    version; two launches give the same bits."""
    P, live = 1030, [0, 1, 2, 3, 4, 5, 1029]
    if which.startswith("merge4"):
        pool = _pool4(P, K, K, dev)
        run, plain_fn, tol = G4.merge4_cuda, G4.merge4_plain, TOL
        args = (1.0, cap)
    elif which.startswith("merge3"):
        pool = _pool3(P, K, K, dev)
        run, plain_fn, tol = G3.merge3_cuda, G3.merge3_plain, \
            dict(rtol=2e-4, atol=1e-3)
        args = (4.0, cap)
    else:
        pool = _pool(P, K, K, dev)
        metric = 1 if which.endswith("1") else 0
        run, plain_fn, tol = G.merge_cuda, G.merge_plain, TOL
        args = (0.6 if metric else 5.0, cap, metric)
    w = torch.zeros_like(pool[0])
    w[live] = _edge_weights(pool[0][live])
    pool[0] = w
    kern, again = run(*pool, *args), run(*pool, *args)
    sub = [t[live] for t in pool]
    plain = plain_fn(*sub, *args)
    torch.cuda.synchronize()
    for k, a, q in zip(kern, again, plain):
        assert torch.equal(k, a)
        torch.testing.assert_close(k[live], q, **tol)
    assert not kern[0][6:-1].any()
    n_live = (kern[0][live] > 0).sum(1)
    assert n_live[0] == 0 and n_live[1] == 1 and bool((n_live[2:] > 1).all())


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
    (9, 1100, 301, 1.0),            # 73 KB of shared memory per CTA
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


def _degenerate_cov3(covs, seed):
    """covs (six [P, K] channels) with a quarter of the candidates zero, a
    quarter singular (rank 1), a quarter near-singular (rank 1 + 1e-3 I)
    and a quarter slightly indefinite (rank 1 - 1e-3 I)."""
    rng = np.random.default_rng(seed)
    P, K = covs[0].shape
    u = rng.normal(size=(3, P, K)) * 4.0
    kind = rng.integers(0, 4, (P, K))
    out = []
    for (i, j) in G3.PAIRS:
        rank1 = u[i] * u[j]
        eye = 1e-3 if i == j else 0.0
        alt = np.where(kind == 0, 0.0, np.where(
            kind == 1, rank1, np.where(kind == 2, rank1 + eye, rank1 - eye)))
        out.append(torch.as_tensor(alt.astype(np.float32),
                                   device=covs[0].device))
    return out


@pytest.mark.parametrize("P,K,cap,sep,degenerate", [
    (9, 97, 5, 4.0, False),         # cap reached before the weight runs out
    (9, 97, 200, 4.0, False),       # the weight runs out before cap
    (9, 97, 200, 16.0, True),
    (9, 300, 300, 4.0, True),
    (4, 5051, 200, 4.0, False),     # the widest K: 232,410 B of shared memory
])
def test_merge3_kernel_edge_pools(dev, P, K, cap, sep, degenerate):
    """Ties, dead rows, both ends of the pick loop, the widest pool, and
    zero, singular, near-singular and indefinite averaged covariances
    (where the test's det is 0, tiny or negative), against the plain
    version; two launches give the same bits."""
    pool = _pool3(P, K, P + K + 7, dev)
    pool[0] = _edge_weights(pool[0])
    if degenerate:
        pool[1:4] = [m * 0.05 + 300.0 for m in pool[1:4]]
        pool[4:] = _degenerate_cov3(pool[4:], P + K)
    kern = G3.merge3_cuda(*pool, sep, cap)
    again = G3.merge3_cuda(*pool, sep, cap)
    plain = G3.merge3_plain(*pool, sep, cap)
    torch.cuda.synchronize()
    for k, a, p in zip(kern, again, plain):
        assert torch.equal(k, a)
        torch.testing.assert_close(k, p, rtol=2e-4, atol=1e-3)
    n_live = (kern[0] > 0).sum(1)
    assert n_live[0] == 0 and n_live[1] == 1
    if cap < 10:
        assert bool((n_live == cap).any())
    if cap >= K:
        assert bool((n_live < cap).all())


@pytest.mark.parametrize("P,M,n_pad", [
    (7, 1, 0), (5, 2, 1), (33, 13, 4), (3, 64, 0),
    (2, 256, 17),                   # 8 threads a lane, 32 slots each
    (2, 300, 17),                   # the lanes updated in device memory
    (40, 1, 0), (40, 2, 0), (40, 33, 0), (40, 65, 0), (40, 128, 0),
    (70, 33, -1), (70, 65, -1),     # per-particle -inf: live counts differ
    (700, 64, -1),                  # lanes that fill an H100: 4 threads each
    (37, 64, -2), (37, 128, -2),    # all-sentinel rows beside live ones
])
def test_esf_kernel_matches_plain(dev, P, M, n_pad):
    """Bit for bit (the kernel runs the plain version's operations on the
    same operands, the sentinel, below -1e29, in the same places); no NaN
    anywhere. n_pad > 0: trailing -inf slots; -1: a random 30 % of the
    entries -inf, per particle; -2: every other particle all -inf."""
    rng = np.random.default_rng(P + M)
    ll = rng.uniform(-6.0, 3.0, (P, M)).astype(np.float32)
    if n_pad > 0:
        ll[:, M - n_pad:] = -np.inf
    elif n_pad == -1:
        ll[rng.uniform(size=(P, M)) < 0.3] = -np.inf
    elif n_pad == -2:
        ll[::2] = -np.inf
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
        assert torch.equal(k, p)


def test_esf_log1p_is_the_librarys_on_every_nonnegative_float(dev):
    """The esf kernels' branch-free log1p equals the library's log1pf in
    every bit on every float in [0, inf): what keeps esf bit-identical to
    its plain version."""
    from phdslam_tpu_torch.kernels import _build
    lib, _ = _build.library()
    assert lib.phd_esf_log1p_mismatches() == 0


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
    with pytest.raises(ValueError):
        G4.merge4_cuda(w, mean4, cov4, 1.0, 0)         # max_out 0
    pool3 = _pool3(4, 40, 0, dev)
    with pytest.raises(ValueError):
        G3.merge3_cuda(*pool3[:9], pool3[9].double(), 4.0, 8)
    with pytest.raises(ValueError):
        G3.merge3_cuda(*pool3, 4.0, 0)
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


# ------------------------------------------------------------ auction --

def _auction_inputs(P, M, F, seed, dev, gated=0.6, all_gated=()):
    """FastSLAM's raw benefit (F feature columns, a random share gated out
    at NEG) and a private value: (benefit [P, M, F], pv, budget)."""
    from phdslam_tpu_torch.filter import fastslam as FS
    rng = np.random.default_rng(seed)
    ben = rng.normal(-3.0, 3.0, (P, M, F))
    ben[rng.uniform(size=(P, M, F)) < gated] = FS._NEG
    ben[list(all_gated)] = FS._NEG
    return (torch.as_tensor(ben, dtype=torch.float32, device=dev),
            float(rng.normal(-4.0, 1.0)), FS._BIDS_PER_ROW * (F + M))


def _assert_auction_equal(ben, pv, budget):
    from phdslam_tpu_torch.kernels import auction as A
    col, iters = A.auction_assign_cuda(ben, pv, budget)
    col_p, iters_p = A.auction_assign_plain(ben, pv, budget)
    assert torch.equal(col, col_p)
    assert torch.equal(iters, iters_p)
    P, M, F = ben.shape
    assert int(col.min()) >= 0 and int(col.max()) < F + M
    return col, iters


@pytest.mark.parametrize("P,M,F", [
    (256, 64, 128),        # the shipped FastSLAM cfg
    (1001, 64, 128),       # odd P
    (8192, 64, 512),       # the dense shape
    (3, 5, 17), (2, 1, 1), (5, 40, 0), (7, 33, 95),
])
def test_auction_kernel_matches_plain(dev, P, M, F):
    """Columns and rounds bit for bit (the clamp, the rounds and the
    readout in one launch); a second launch gives the same."""
    from phdslam_tpu_torch.kernels import auction as A
    ben, pv, budget = _auction_inputs(P, M, F, P + M + F, dev)
    col, iters = _assert_auction_equal(ben, pv, budget)
    assert torch.equal(A.auction_assign_cuda(ben, pv, budget)[0], col)
    assert int(iters.min()) >= 1 and int(iters.max()) < budget


def test_auction_kernel_all_gated_particles(dev):
    """Particles whose rows have only their private columns live: one
    round, each row on its own column."""
    ben, pv, budget = _auction_inputs(16, 12, 30, 3, dev,
                                      all_gated=range(0, 16, 2))
    col, iters = _assert_auction_equal(ben, pv, budget)
    assert (iters[::2] == 1).all()
    expect = torch.arange(30, 42, dtype=torch.int32, device=dev)
    assert (col[::2] == expect).all()


def test_auction_kernel_each_side_of_the_shared_memory_edges(dev):
    """Both places a launch may keep its state: shared memory, or a
    device-memory slice per CTA (C at the widest shared state and one past
    it, at M = 8 and M = 64)."""
    from phdslam_tpu_torch.kernels import _build
    lib, _ = _build.library()

    def edge(M):
        lo, hi = M + 1, 1 << 20          # path(M, lo) == 1, at hi 0
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if lib.phd_auction_path(M, mid) == 1 \
                else (lo, mid)
        return lo

    for M, P in ((8, 3), (64, 2)):
        C = edge(M)
        for c in (C, C + 1):
            assert lib.phd_auction_path(M, c) == (1 if c == C else 0)
            assert (lib.phd_auction_wide_floats(P, M, c - M) > 0) == (c > C)
            _assert_auction_equal(*_auction_inputs(P, M, c - M, c, dev))


def test_auction_kernel_nan_benefit_stays_in_range(dev):
    """A NaN in the raw benefit (a NaN pose upstream) is not live: it is
    clamped to the floor, as in JAX, and the rounds end as for any other
    particle; a NaN private value leaves the rows no live private column.
    Columns and rounds as in the plain version, every column in range."""
    ben, pv, budget = _auction_inputs(8, 16, 40, 9, dev)
    ben[1, 3, 7] = float("nan")
    ben[4] = float("nan")
    ben[5, :, 30] = float("nan")
    col, iters = _assert_auction_equal(ben, pv, budget)
    assert int(iters.max()) < budget
    assert (col[4] == torch.arange(40, 56, dtype=torch.int32,
                                   device=dev)).all()
    _assert_auction_equal(ben, float("nan"), 300)


def test_auction_kernel_budget(dev):
    """A budget below what the rows need stops every particle there and the
    rows left take their best column only they can win, as in the plain
    version; a budget of 0 runs no round and every row falls back."""
    ben, pv, _ = _auction_inputs(64, 32, 64, 11, dev, gated=0.2)
    for budget in (2, 1):
        _, iters = _assert_auction_equal(ben, pv, budget)
        assert int(iters.max()) == budget
    col, iters = _assert_auction_equal(ben, pv, 0)
    assert int(iters.max()) == 0


@pytest.mark.parametrize("assoc", [0, 1])
def test_fastslam_slam_step_cuda_matches_cpu(dev, assoc):
    """Three FastSLAM steps on the card and on the CPU, from the same state
    with the same draws: counters and slot order exact."""
    cfg = load_config("cfg/fastslam_synth.cfg").replace(
        n_particles=32, maxFeatures=32, maxMeasurements=16, y0=0.0,
        stdRange=0.25, clutterRate=2.0, fastslamAssoc=assoc)
    rng = np.random.default_rng(6)
    lm = np.stack([rng.uniform(1, 9, 10), rng.uniform(-6, 6, 10)], 1)
    states = {d: SlamState.create(cfg, d) for d in ("cpu", dev)}
    for t in range(3):
        d = lm - [0.5 * t, 0.0]
        r = np.hypot(d[:, 0], d[:, 1]) + rng.normal(0, 0.1, 10)
        b = np.arctan2(d[:, 1], d[:, 0]) + rng.normal(0, 0.01, 10)
        rb = np.zeros((16, 2), np.float32)
        rb[:10] = np.stack([r, b], 1)
        rb[10:13] = np.stack([rng.uniform(1, 9, 3),
                              rng.uniform(-1.4, 1.4, 3)], 1)
        valid = np.arange(16) < 13
        normals = torch.as_tensor(rng.normal(size=(1, 32, 2)),
                                  dtype=torch.float32)
        u = torch.as_tensor(rng.uniform(size=32), dtype=torch.float32)
        for dv in states:
            z = Measurements.from_numpy(rb, np.zeros(16, np.int32), valid, dv)
            states[dv], _ = slam_step(states[dv], (0.5, 0.0), z, 1.0, t > 0,
                                      cfg, noise=(normals.to(dv), u.to(dv)))
    cpu, gpu = states["cpu"], states[dev].to("cpu")
    torch.testing.assert_close(gpu.pose, cpu.pose, **TOL)
    torch.testing.assert_close(gpu.log_weights, cpu.log_weights,
                               rtol=2e-4, atol=1e-4)
    assert torch.equal(gpu.resample_idx, cpu.resample_idx)
    assert torch.equal(gpu.map_static.w, cpu.map_static.w)
    for name in ("mx", "my", "c00", "c01", "c11"):
        torch.testing.assert_close(getattr(gpu.map_static, name),
                                   getattr(cpu.map_static, name),
                                   rtol=2e-4, atol=1e-4)
    assert float(cpu.map_static.w.max()) >= 3.0


# ----------------------------------------------------- square auction --

def _square_costs(B, n, seed, dev):
    """OSPA's padded costs for B random set pairs (scripts/ospa_latency.py's
    draws: each set half to fully real, points N(0, 8), p = 1, c = 5),
    built as ospa_torch builds them, on the card: [B, n, n]."""
    from phdslam_tpu_torch.ops import ospa as O
    costs = []
    for b in range(B):
        r = np.random.default_rng(seed + b)
        m_x = int(r.integers(n // 2, n + 1))
        m_y = int(r.integers(n // 2, n + 1))
        x = torch.as_tensor(r.normal(0, 8, (n, 2)), dtype=torch.float32,
                            device=dev)
        y = torch.as_tensor(r.normal(0, 8, (n, 2)), dtype=torch.float32,
                            device=dev)
        ar = torch.arange(n, device=dev)
        costs.append(O.padded_cost(x, ar < m_x, y, ar < m_y, 1.0, 5.0)[1])
    return torch.stack(costs).contiguous()


def _assert_square_equal(cost, budget):
    from phdslam_tpu_torch.kernels import auction as A
    from phdslam_tpu_torch.ops import ospa as O
    eps = O.eps_schedule(cost.device)
    owner, iters = A.auction_square_cuda(cost, eps, budget)
    owner_p, iters_p = A.auction_square_plain(cost, eps, budget)
    assert torch.equal(owner, owner_p)
    assert torch.equal(iters, iters_p)
    n = cost.shape[1]
    assert (owner.sort(1).values == torch.arange(n, device=cost.device)).all()
    return owner, iters


@pytest.mark.parametrize("B,n", [(8, 16), (8, 64), (8, 256), (3, 1),
                                 (5, 2), (4, 37), (2, 230), (2, 255),
                                 (2, 256)])
def test_square_auction_kernel_matches_plain(dev, B, n):
    """Owners and the rounds of each phase bit for bit, at the default
    budget of 16 n a phase; the cost stays on chip: in shared memory up to
    n = 230, in shared memory and registers at 255 and 256 (256 KiB, past a
    CTA's shared memory)."""
    from phdslam_tpu_torch.kernels import _build
    lib, _ = _build.library()
    assert lib.phd_auction_square_path(n) == (3 if n >= 255 else 2)
    owner, iters = _assert_square_equal(_square_costs(B, n, 7 * n, dev),
                                        16 * n)
    assert int(iters.min()) >= 1 and int(iters.max()) < 16 * n


def test_square_auction_kernel_budget(dev):
    """Two rounds a phase: the phases stop at the budget and the clean-up
    pairs the rows left with the free columns in index order, as in the
    plain version."""
    _, iters = _assert_square_equal(_square_costs(8, 64, 3, dev), 2)
    assert int(iters[:, -1].min()) == 2


def test_square_auction_kernel_each_side_of_the_shared_memory_edge(dev):
    """The cost in shared memory at the largest n that fits, in shared
    memory and registers one past it; in shared memory and registers at n
    = 256 (the registers' edge), read from device memory at 257."""
    from phdslam_tpu_torch.kernels import _build
    lib, _ = _build.library()
    n = 1
    while lib.phd_auction_square_path(n + 1) == 2:
        n += 1
    assert lib.phd_auction_square_path(n + 1) == 3
    assert lib.phd_auction_square_path(256) == 3
    assert lib.phd_auction_square_path(257) == 1
    for m in (n, n + 1, 256, 257):
        _assert_square_equal(_square_costs(2, m, m, dev), 16 * m)


def test_ospa_torch_cuda_matches_cpu(dev):
    """ospa_torch on the card: 0-d tensors on the card, within
    tests/test_ospa.py's large-set tolerance of the same call on the CPU
    (the two may round a distance apart, and then stop at another
    eps-optimal assignment; the cardinality term to 1e-4), and the launch
    counted once a call."""
    from phdslam_tpu_torch.kernels import auction as A
    from phdslam_tpu_torch.ops import ospa as O
    r = np.random.default_rng(12)
    x = r.normal(0, 8, (64, 2)).astype(np.float32)
    y = r.normal(0, 8, (64, 2)).astype(np.float32)
    xv, yv = np.arange(64) < 50, np.arange(64) < 61
    args = lambda d: [torch.as_tensor(a, device=d) for a in (x, xv, y, yv)]
    before = A.launches_square
    got = O.ospa_torch(*args(dev), p=1.0, c=5.0)
    assert A.launches_square == before + 1
    ref = O.ospa_torch(*args("cpu"), p=1.0, c=5.0)
    for g, e, tol in zip(got, ref, (2e-2, 2e-2, 1e-4)):
        assert g.device.type == "cuda" and g.shape == ()
        assert abs(float(g) - float(e)) < tol


def _no_sync(fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): any operation
    that makes the host wait for the device raises. Inputs are put on the
    card before; a warm-up call has built and loaded the kernels and
    cached the step's constants on the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("filter_type", [0, 1])
def test_batched_step_with_a_mixed_gate_never_syncs(dev, filter_type):
    """Three runs stepped together, run 1 without measurements at step 1
    (the per-run update gate) and so without CPHD births at step 2: every
    step runs under set_sync_debug_mode("error") on the card and equals
    the CPU's on the same draws."""
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=32, maxFeatures=32, maxMeasurements=16, y0=0.0,
        birthWeight=0.02, filterType=filter_type, maxCardinality=63,
        resampleThresh=2.0)
    R, M = 3, 16
    rng = np.random.default_rng(8)
    states = {d: SlamState.create(cfg, d, n_runs=R) for d in ("cpu", dev)}
    prev = {d: None for d in states}
    for t in range(3):
        rb = np.stack([rng.uniform(0.5, 9, (R, M)),
                       rng.uniform(-1.4, 1.4, (R, M))], -1).astype(np.float32)
        valid = np.tile(np.arange(M) < 12, (R, 1))
        if t == 1:
            valid[1] = False
        normals = torch.as_tensor(rng.normal(size=(1, R * 32, 2)),
                                  dtype=torch.float32)
        u = torch.as_tensor(rng.uniform(size=R * 32), dtype=torch.float32)
        for d in states:
            z = Measurements.from_numpy(rb, np.zeros((R, M), np.int32), valid,
                                        d)
            noise = (normals.to(d), u.to(d))
            step = lambda: slam_step(states[d], (1.0, 0.05), z, 1.0, t > 0,
                                     cfg, noise=noise, z_prev=prev[d])
            states[d], aux = _no_sync(step) if d != "cpu" else step()
            prev[d] = z
    cpu, gpu = states["cpu"], states[dev].to("cpu")
    torch.testing.assert_close(gpu.pose, cpu.pose, **TOL)
    torch.testing.assert_close(gpu.log_weights, cpu.log_weights,
                               rtol=2e-4, atol=1e-3)
    assert torch.equal(gpu.resample_idx, cpu.resample_idx)


def test_island_step_cuda_matches_cpu_without_sync(dev):
    """Three island steps (4 islands of 8, the exchange forced) on the card
    under set_sync_debug_mode("error") and on the CPU, from the same state
    with the same draws."""
    from phdslam_tpu_torch.parallel import island as I
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=32, maxFeatures=32, maxMeasurements=16, y0=0.0,
        birthWeight=0.02)
    n = 4
    rng = np.random.default_rng(9)
    runs = {d: I.init_islands(cfg, n, d) for d in ("cpu", dev)}
    prev = {d: None for d in runs}
    for t in range(3):
        rb = np.stack([rng.uniform(0.5, 9, 16), rng.uniform(-1.4, 1.4, 16)],
                      1).astype(np.float32)
        valid = np.arange(16) < 12
        noise = (torch.as_tensor(rng.normal(size=(1, 32, 2)),
                                 dtype=torch.float32),
                 torch.as_tensor(rng.uniform(size=32), dtype=torch.float32),
                 torch.as_tensor(rng.uniform(size=(2, 32)),
                                 dtype=torch.float32))
        for d in runs:
            z = Measurements.from_numpy(rb, np.zeros(16, np.int32), valid, d)
            on_d = tuple(x.to(d) for x in noise)
            step = lambda: I.island_slam_step(
                *runs[d], (1.0, 0.05), z, 1.0, t > 0, cfg, n, thresh=1.1,
                noise=on_d, z_prev=prev[d])
            st, ilw, aux = _no_sync(step) if d != "cpu" else step()
            runs[d] = (st, ilw)
            prev[d] = z
        assert bool(aux.exchanged)
    (cpu, cilw), (gpu, gilw) = runs["cpu"], runs[dev]
    gpu = gpu.to("cpu")
    torch.testing.assert_close(gpu.pose, cpu.pose, **TOL)
    torch.testing.assert_close(gilw.cpu(), cilw, **TOL)
    assert torch.equal(gpu.resample_idx, cpu.resample_idx)
    for name in ("w", "mx", "my", "c00", "c01", "c11"):
        torch.testing.assert_close(getattr(gpu.map_static, name),
                                   getattr(cpu.map_static, name),
                                   rtol=2e-4, atol=1e-4)


def test_sharded_step_on_one_nccl_rank_matches_slam_step(dev, tmp_path):
    """The sharded step on a one-rank NCCL mesh (``parallel/mesh.py``) at
    the shipped static shape (256 x 128 x 64), 3 steps with the resample
    forced, equals ``slam_step`` on the same draws bit for bit: every state
    leaf and aux value; the steps run under set_sync_debug_mode("error")."""
    from phdslam_tpu_torch.parallel import mesh as PM
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=256, maxFeatures=128, maxMeasurements=64, y0=0.0,
        birthWeight=0.02, resampleThresh=1.1)
    rng = np.random.default_rng(12)
    mesh = PM.make_mesh(device=dev, rank=0, world_size=1,
                        init_method=f"file://{tmp_path / 'rdv'}")
    try:
        assert mesh.backend == "nccl"
        step = PM.sharded_step(cfg, mesh)
        plain = SlamState.create(cfg, dev)
        sharded = PM.shard_state(SlamState.create(cfg, dev), mesh)
        for t in range(3):
            rb = np.stack([rng.uniform(0.5, 9, 64), rng.uniform(-1.4, 1.4,
                                                                64)],
                          1).astype(np.float32)
            z = Measurements.from_numpy(rb, np.zeros(64, np.int32),
                                        np.arange(64) < 48, dev)
            noise = (torch.randn((1, 256, 2), device=dev),
                     torch.rand((256,), device=dev))
            plain, paux = slam_step(plain, (1.0, 0.05), z, 1.0, t > 0, cfg,
                                    noise=noise)
            sharded, saux = _no_sync(lambda: step(sharded, (1.0, 0.05), z,
                                                  1.0, t > 0, noise=noise))
            for a, b in zip(paux, saux):
                assert torch.equal(a, b)
        got = PM.unshard_state(sharded, mesh)
        for name in ("pose", "log_weights", "resample_idx", "variances"):
            assert torch.equal(getattr(got, name), getattr(plain, name))
        for name in ("w", "mx", "my", "c00", "c01", "c11"):
            assert torch.equal(getattr(got.map_static, name),
                               getattr(plain.map_static, name))
        assert bool(paux.resampled)
    finally:
        mesh.close()


@pytest.mark.parametrize("d", [2, 3])
def test_greedy_merge_batch_cuda_matches_cpu(dev, d):
    """ops/gm.py::greedy_merge_batch on CUDA tensors (the merge or merge3
    kernel, leading dims [4, 64] flattened) against the same call on CPU
    tensors (the plain version)."""
    from phdslam_tpu_torch.ops.gm import greedy_merge_batch
    rng = np.random.default_rng(40 + d)
    w = rng.uniform(0.05, 1.0, (4, 64, 96)) * (rng.uniform(size=(4, 64, 96))
                                                < 0.8)
    mean = rng.uniform(-4, 4, (4, 64, 96, d))
    a = rng.normal(size=(4, 64, 96, d, d))
    cov = a @ np.swapaxes(a, -1, -2) / d + 0.3 * np.eye(d)
    args = [np.asarray(x, np.float32) for x in (w, mean, cov)]
    launches = (G if d == 2 else G3).launches
    cpu = greedy_merge_batch(*map(torch.as_tensor, args), 4.0, 40)
    got = greedy_merge_batch(*(torch.as_tensor(x, device=dev)
                               for x in args), 4.0, 40)
    assert (G if d == 2 else G3).launches == launches + 1
    for k, p in zip(got, cpu):
        torch.testing.assert_close(k.cpu(), p, **TOL)


def _merge_down_pools(dev):
    """Pools whose picks absorb most candidates, so that the pick loop ends
    in a long scan of merged positions: the dense update's own pool on
    merge_pools.make_problem's overlapping maps (2-D, [8192, 1088] ->
    512), and 4-D and 3-D pools of 2048 particles x 1088 and 560
    candidates in boxes a few covariances wide."""
    from phdslam_tpu_torch.filter import update as U
    from phdslam_tpu_torch.kernels.merge3 import PAIRS
    from merge_pools import make_problem
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=8192, maxFeatures=512, maxMeasurements=64,
        clutterRate=40.0, gateBirths=True, gateThreshold=9.0)
    pose, gm, z = make_problem(np.random.default_rng(1), cfg, 8192, 512, 64,
                               dev)
    seen = []
    real = G.merge_cuda
    try:
        G.merge_cuda = lambda *a: seen.append(a) or real(*a)
        U.phd_update_static(pose, gm, z.rb, z.label, z.valid, cfg)
    finally:
        G.merge_cuda = real
    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    P = 2048
    w4 = (rng.uniform(size=(P, 1088)) < 0.8) * rng.uniform(0.01, 2, (P, 1088))
    a = rng.normal(size=(4, 4, P, 1088)).astype(np.float32) * 0.5
    c4 = np.stack([(a[i] * a[j]).sum(0) + (0.2 if i == j else 0.0)
                   for i in range(4) for j in range(i, 4)], 1)
    mean4 = np.concatenate([rng.uniform(-3, 3, (P, 2, 1088)),
                            rng.normal(0, 0.3, (P, 2, 1088))], 1)
    pool4 = (t(w4), t(mean4), t(c4))
    w3 = (rng.uniform(size=(P, 560)) < 0.8) * rng.uniform(0.01, 2, (P, 560))
    b = rng.normal(size=(3, 3, P, 560)).astype(np.float32) * 2.0
    c3 = [(b[i] * b[j]).sum(0) + (4.0 if i == j else 0.0) for i, j in PAIRS]
    pool3 = [t(w3), t(rng.uniform(300, 310, (P, 560))),
             t(rng.uniform(200, 210, (P, 560))),
             t(rng.uniform(100, 110, (P, 560)))] + [t(c) for c in c3]
    return ((G.merge_cuda, G.merge_plain, seen[0], 512, TOL),
            (G4.merge4_cuda, G4.merge4_plain, (*pool4, 1.0, 512), 512, TOL),
            (G3.merge3_cuda, G3.merge3_plain, (*pool3, 4.0, 128), 128,
             dict(rtol=2e-4, atol=1e-3)))


def test_merge_kernels_repeat_bit_for_bit_on_pools_that_merge_down(dev):
    """merge, merge4 and merge3 launched 25 times each on pools that merge
    down to few slots: the first launch agrees with the plain version at
    the other merge tests' bars, and every launch completes and equals the
    first bit for bit (a warp that left the pick loop used to relink the
    member lists while another still scanned them: an illegal address in
    about one launch of a few hundred on such pools)."""
    for fn, plain_fn, args, cap, tol in _merge_down_pools(dev):
        first = fn(*args)
        torch.cuda.synchronize()
        live = int((first[0] > 0).sum(1).max())
        assert 0 < live < cap                    # the loop ended early
        for k, q in zip(first, plain_fn(*args)):
            torch.testing.assert_close(k, q, **tol)
        for _ in range(25):
            out = fn(*args)
            torch.cuda.synchronize()
            for x, y in zip(out, first):
                assert torch.equal(x, y)

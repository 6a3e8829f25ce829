"""The pre-update kernel (``kernels/preupdate.py``, ``csrc/preupdate.cu``).

On the CPU: the filter's ``kalman_preupdate`` runs the plain version bit
for bit and launches nothing; the library's C signature matches the
source; the CUDA route refuses CPU tensors before it builds anything; every
filter's update runs the pre-update once.

On the card (marked ``cuda``, skipped without a GPU), without the suite's
JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_preupdate.py

the kernel's 15 channels equal the plain chain's on the same CUDA tensors
bit for bit (the benchmark cells' shapes, odd shapes, unaligned channels),
each static, CPHD, FastSLAM and mixed update launches it once, and 20
static steps give the plain chain's state bit for bit.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from phdslam_tpu_torch import load_config, simdata
from phdslam_tpu_torch.filter import update
from phdslam_tpu_torch.filter.state import Measurements, SlamState
from phdslam_tpu_torch.filter.step import draw_noise, slam_step
from phdslam_tpu_torch.kernels import _build
from phdslam_tpu_torch.kernels import preupdate as K
from preupdate_cases import (preupdate_channels_differing,
                             random_preupdate_inputs)

torch.set_num_threads(1)

TINY = dict(n_particles=8, maxFeatures=16, maxMeasurements=8,
            birthWeight=0.02, stdEncoder=0.05, stdAlpha=0.005, y0=0.0)
#: cfg file and overrides of each filter whose update runs the pre-update
BRANCHES = {
    "static": ("cfg/ackerman_synth.cfg", {}),
    "cphd": ("cfg/ackerman_synth.cfg", dict(filterType=1)),
    "fastslam": ("cfg/ackerman_synth.cfg", dict(filterType=2)),
    "mixed": ("cfg/mixed_synth.cfg", dict(clutterRate=2.0)),
}


@pytest.fixture(scope="module")
def run():
    sc = simdata.make_scenario(np.random.default_rng(11), n_landmarks=12,
                               n_steps=6, clutter_rate=2.0)
    return simdata.generate_run(np.random.default_rng(12), sc,
                                control_noise=(0.05, 0.005))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _z(meas_t, M, device=None):
    rb = np.zeros((M, 2), np.float32)
    valid = np.zeros((M,), bool)
    k = min(len(meas_t), M)
    rb[:k] = meas_t[:k]
    valid[:k] = True
    return Measurements.from_numpy(rb, np.zeros((M,), np.int32), valid,
                                   device)


def _tensors(tree):
    """Every tensor of a state (its mixtures' channels included)."""
    out = []
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if dataclasses.is_dataclass(v):
            out += _tensors(v)
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def _preupdates_of_each_step(branch, run, device, count, n=3):
    """count()'s rise over each of n steps of the branch, and whether the
    step had a measurement."""
    path, kw = BRANCHES[branch]
    cfg = load_config(path).replace(**{**TINY, **kw})
    controls, meas = run
    gen = torch.Generator(device=device).manual_seed(5)
    state = SlamState.create(cfg, device)
    z_prev, counts = None, []
    for t in range(n):
        z = _z(meas[t], cfg.maxMeasurements, device)
        before = count()
        state, _ = slam_step(
            state, (float(controls[t, 0]), float(controls[t, 1])), z, 1.0,
            t > 0, cfg, generator=gen, z_prev=z_prev)
        counts.append(count() - before)
        z_prev = z
    return counts, [int(len(m) > 0) for m in meas[:n]]


@pytest.mark.parametrize("P,F", [(37, 129), (1, 5), (16, 16)])
def test_cpu_route_is_the_plain_version_and_launches_nothing(P, F):
    cfg, pose, gm = random_preupdate_inputs(P, F, P + F, "cpu")
    before = K.launches
    got = update.kalman_preupdate(pose, gm, cfg)
    assert K.launches == before
    assert preupdate_channels_differing(
        got, K.preupdate_plain(pose, gm, cfg)) == {}
    assert got.rclass.dtype == torch.int32
    assert set(got.rclass.unique().tolist()) <= {0, 1, 2}


def test_library_signature_matches_the_source():
    src = (_build.CSRC / "preupdate.cu").read_text()
    params = re.search(r"int phd_preupdate_launch\(([^)]*)\)", src).group(1)
    kinds = {"float*": _build._P, "int*": _build._P, "void*": _build._P,
             "int": _build._I, "float": _build._F}
    want = []
    for p in params.split(","):
        typ = " ".join(p.replace("const ", "").split()[:-1])
        want.append(kinds[typ.replace(" *", "*")])
    assert _build.SIGNATURES["phd_preupdate_launch"] == want
    assert "phd_preupdate_launch" not in _build.RESTYPES    # an int


def test_cuda_route_refuses_cpu_tensors_before_building(monkeypatch):
    def no_build():
        raise AssertionError("built the library for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    cfg, pose, gm = random_preupdate_inputs(4, 8, 0, "cpu")
    with pytest.raises(ValueError, match="not CUDA"):
        K.preupdate_cuda(pose, gm, cfg)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_each_update_runs_the_preupdate_once(branch, run, monkeypatch):
    calls = []
    plain = K.preupdate_plain
    monkeypatch.setattr(K, "preupdate_plain",
                        lambda *a: calls.append(1) or plain(*a))
    before = K.launches
    counts, updated = _preupdates_of_each_step(branch, run, None,
                                               lambda: len(calls))
    assert counts == updated and any(updated)
    assert K.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("P,F,offset", [
    (8192, 512, 0), (65536, 128, 0),    # the benchmark cells' shapes
    (37, 129, 0), (1, 5, 0),            # odd: one element a thread
    (64, 128, 1),                       # channels 4-byte aligned only
])
def test_kernel_equals_the_plain_chain_bit_for_bit(dev, P, F, offset):
    cfg, pose, gm = random_preupdate_inputs(P, F, P + F, dev)
    if offset:
        def shifted(c):
            buf = torch.empty(P * F + offset, device=dev)
            buf[offset:] = c.flatten()
            return buf[offset:].view(P, F)
        gm = gm.map(shifted)
    before = K.launches
    got = K.kalman_preupdate(pose, gm, cfg)
    assert K.launches == before + 1
    plain = K.preupdate_plain(pose, gm, cfg)
    torch.cuda.synchronize()
    assert preupdate_channels_differing(got, plain) == {}
    for name, c in zip(got._fields, got):
        assert c.is_contiguous() and c.shape == (P, F), name
        assert c.dtype == (torch.int32 if name == "rclass"
                           else torch.float32), name
    if P * F > 1000:                    # every range class appears
        assert set(got.rclass.unique().tolist()) == {0, 1, 2}


@pytest.mark.cuda
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_one_launch_per_update_on_the_card(dev, branch, run):
    counts, updated = _preupdates_of_each_step(branch, run, dev,
                                               lambda: K.launches)
    assert counts == updated and any(updated)


@pytest.mark.cuda
def test_twenty_static_steps_are_the_plain_chains_bit_for_bit(dev,
                                                              monkeypatch):
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=2048, maxFeatures=256, maxMeasurements=64,
        birthWeight=1e-3, y0=0.0, clutterRate=20.0)
    sc = simdata.make_scenario(np.random.default_rng(3), n_steps=20,
                               clutter_rate=20.0)
    controls, meas = simdata.generate_run(np.random.default_rng(4), sc,
                                          control_noise=(0.05, 0.005))
    gen = torch.Generator(device=dev).manual_seed(1)
    zs = [_z(m, cfg.maxMeasurements, dev) for m in meas[:20]]
    noises = [draw_noise(cfg, cfg.n_particles, dev, gen) for _ in zs]

    def steps():
        state = SlamState.create(cfg, dev)
        for t in range(20):
            state = slam_step(
                state, (float(controls[t, 0]), float(controls[t, 1])),
                zs[t], 1.0, t > 0, cfg, noise=noises[t],
                z_prev=zs[t - 1] if t else None)[0]
        return _tensors(state)

    before = K.launches
    kernel = steps()
    assert K.launches - before == sum(len(m) > 0 for m in meas[:20])
    monkeypatch.setattr(update, "kalman_preupdate", K.preupdate_plain)
    plain = steps()
    assert K.launches - before == sum(len(m) > 0 for m in meas[:20])
    assert len(kernel) == len(plain)
    for i, (k, p) in enumerate(zip(kernel, plain)):
        if k.is_floating_point():
            k, p = k.view(torch.int32), p.view(torch.int32)
        assert torch.equal(k, p), i

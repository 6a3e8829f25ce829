"""The port's checkpoints (``phdslam_tpu_torch/checkpoint.py``) against the
JAX package's (``phdslam_tpu/checkpoint.py``): the same file names and
retention for the same steps, and a bit-for-bit round trip of every state
kind with the generator's state, after which a step of the restored state
equals a step of the original. No pickled class: the files load with
``allow_pickle=False``."""

import os

import jax
import numpy as np
import pytest
import torch

from phdslam_tpu import checkpoint as JCK
from phdslam_tpu.config import load_config as jax_load_config
from phdslam_tpu.filter.state import SlamState as JSlamState
from phdslam_tpu_torch import checkpoint as CK
from phdslam_tpu_torch import load_config
from phdslam_tpu_torch.bridge import (disparity_state_to_numpy,
                                      state_to_numpy)
from phdslam_tpu_torch.filter.disparity import DisparityState
from phdslam_tpu_torch.filter.state import Measurements, SlamState
from phdslam_tpu_torch.filter.step import slam_step

torch.set_num_threads(1)

TINY = dict(n_particles=8, maxFeatures=16, maxMeasurements=8,
            birthWeight=1e-3, y0=0.0)


def test_retention_and_latest_match_jax(tmp_path):
    jcfg = jax_load_config("cfg/ackerman_synth.cfg").replace(**TINY)
    tcfg = load_config("cfg/ackerman_synth.cfg").replace(**TINY)
    jstate, key = JSlamState.create(jcfg), jax.random.PRNGKey(0)
    tstate, gen = SlamState.create(tcfg), torch.Generator().manual_seed(0)
    names = {}
    for who in ("jax", "port"):
        d = tmp_path / who
        for t in (1, 2, 3, 12, 7, 100):
            if who == "jax":
                JCK.save_checkpoint(str(d), t, jstate, key, keep=3)
            else:
                path = CK.save_checkpoint(str(d), t, tstate, gen, keep=3)
                assert path == str(d / f"ckpt_{t:06d}.npz")
        latest = {"jax": JCK, "port": CK}[who].latest_checkpoint(str(d))
        names[who] = (sorted(p for p in os.listdir(d)
                             if p.startswith("ckpt_")),
                      os.path.basename(latest))
    assert names["port"] == names["jax"]
    assert names["port"] == (["ckpt_000007.npz", "ckpt_000012.npz",
                              "ckpt_000100.npz"], "ckpt_000100.npz")
    assert sorted(os.listdir(tmp_path / "port")) == names["port"][0]
    assert CK.latest_checkpoint(str(tmp_path / "none")) is None


def _measurements(cfg, seed):
    rng = np.random.default_rng(seed)
    m = cfg.maxMeasurements
    rb = np.zeros((m, 2), np.float32)
    rb[:5] = np.stack([rng.uniform(2, 10, 5), rng.uniform(-1, 1, 5)], 1)
    valid = np.arange(m) < 5
    return Measurements.from_numpy(rb, np.zeros(m, np.int32), valid)


def _stepped(kind, gen):
    """A state of each kind after a step or two on the CPU."""
    if kind == "disparity":
        cfg = load_config("cfg/disparity_synth.cfg").replace(
            n_particles=4, maxFeatures=8, particlesPerFeature=8)
        s = DisparityState.create(cfg)
        w = torch.rand(s.w.shape, generator=gen)
        return s.replace(w=w, px=torch.randn(s.px.shape, generator=gen),
                         pose=s.pose + torch.rand(s.pose.shape,
                                                  generator=gen)), cfg
    extra = dict(static={}, cphd=dict(filterType=1, maxCardinality=15),
                 mixed=dict(featureModel=2))[kind]
    cfg = load_config("cfg/ackerman_synth.cfg").replace(**TINY, **extra)
    state = SlamState.create(cfg)
    for t in range(2):
        state, _ = slam_step(state, (1.0, 0.05), _measurements(cfg, t), 1.0,
                             t > 0, cfg, generator=gen)
    return state, cfg


def _host(state):
    return (disparity_state_to_numpy(state)
            if isinstance(state, DisparityState) else state_to_numpy(state))


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["static", "cphd", "mixed", "disparity"])
def test_round_trip_bit_for_bit(tmp_path, kind):
    """Every field, None ones included, and the generator's state come back
    exactly; the file holds only plain arrays and names its state kind."""
    gen = torch.Generator().manual_seed(11)
    state, _ = _stepped(kind, gen)
    path = CK.save_checkpoint(str(tmp_path), 42, state, gen)
    with np.load(path, allow_pickle=False) as data:
        assert str(data["kind"]) == ("disparity" if kind == "disparity"
                                     else "slam")
    back, gen_state, step = CK.restore_checkpoint(path, device="cpu")
    assert step == 42 and type(back) is type(state)
    _assert_same(_host(state), _host(back))
    assert torch.equal(gen_state, gen.get_state())
    if kind != "cphd" and kind != "disparity":
        assert back.cardinality is None and back.cn_birth is None


@pytest.mark.parametrize("kind", ["static", "cphd"])
def test_restored_state_steps_as_the_original(tmp_path, kind):
    """resume() gives the state and sets the generator as they stood at
    the checkpoint: the next step from there equals the next step of the
    original run, bit for bit."""
    gen = torch.Generator().manual_seed(5)
    state, cfg = _stepped(kind, gen)
    CK.save_checkpoint(str(tmp_path), 2, state, gen)
    z = _measurements(cfg, 9)
    ref, _ = slam_step(state, (1.0, 0.05), z, 1.0, True, cfg, generator=gen)
    gen2 = torch.Generator().manual_seed(999)
    fresh = SlamState.create(cfg)
    back, start = CK.resume(str(tmp_path), "cpu", gen2, fresh)
    assert start == 3 and back is not fresh
    got, _ = slam_step(back, (1.0, 0.05), z, 1.0, True, cfg, generator=gen2)
    _assert_same(state_to_numpy(ref), state_to_numpy(got))
    same, start = CK.resume(str(tmp_path / "empty"), "cpu", gen2, fresh)
    assert same is fresh and start == 0

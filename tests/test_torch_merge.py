"""The merge kernel's plain version against the JAX package's XLA
``ops/gm.greedy_merge_channels`` (the route JAX takes on the CPU), at the
shapes tests/test_pallas.py holds the Pallas merge to.

Tolerance: rtol 1e-5 / atol 1e-6 on weights and means, as there; 1e-4 /
1e-5 on covariances, because the kernel's one-pass centred moments and the
XLA two-pass moments differ in rounding (tests/test_pallas.py uses the same
bound for the 4-D merge)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.ops import gm as JGM
from phdslam_tpu_torch.kernels import merge as TM
from phdslam_tpu_torch.ops import gm as TGM

torch.set_num_threads(1)

NAMES = ("w", "mx", "my", "c00", "c01", "c11")


def _pool(rng, P, K, corr=0.4, zero_rows=()):
    w = (rng.uniform(size=(P, K)) < 0.6) * rng.uniform(0.01, 2.0, (P, K))
    w[list(zero_rows)] = 0.0
    mx = rng.uniform(-20, 20, (P, K))
    my = rng.uniform(-20, 20, (P, K))
    c00 = rng.uniform(0.05, 1.5, (P, K))
    c11 = rng.uniform(0.05, 1.5, (P, K))
    c01 = corr * np.sqrt(c00 * c11) * rng.uniform(-1, 1, (P, K))
    return [a.astype(np.float32) for a in (w, mx, my, c00, c01, c11)]


def _check(got, ref, tag=""):
    for name, g, r in zip(NAMES, got, ref):
        cov = name.startswith("c")
        np.testing.assert_allclose(
            g.numpy(), np.asarray(r), rtol=1e-4 if cov else 1e-5,
            atol=1e-5 if cov else 1e-6, err_msg=f"{tag} {name}")


@pytest.mark.parametrize("P,K,cap,metric,sep", [
    (32, 160, 64, 0, 4.0),      # metric 0
    (25, 96, 48, 0, 4.0),       # odd particle count
    (16, 96, 7, 0, 4.0),        # odd cap, reached before the pool empties
    (16, 96, 33, 0, 4.0),       # odd cap
    (32, 128, 48, 1, 0.6),      # Hellinger
])
def test_plain_merge_matches_xla(rng, P, K, cap, metric, sep):
    arrs = _pool(rng, P, K, corr=0.3 if metric else 0.4, zero_rows=(1,))
    ref = JGM.greedy_merge_channels(*(jnp.asarray(a) for a in arrs), sep,
                                    cap, metric=metric, use_pallas=False)
    got = TM.merge_plain(*(torch.as_tensor(a) for a in arrs), sep, cap,
                         metric)
    for g in got:
        assert g.shape == (P, cap)
    _check(got, ref, f"P={P} cap={cap} metric={metric}")
    # the all-zero row is an empty map: w 0, mean 0, identity covariance
    np.testing.assert_array_equal(got[0][1].numpy(), 0.0)
    np.testing.assert_array_equal(got[3][1].numpy(), 1.0)
    np.testing.assert_array_equal(got[4][1].numpy(), 0.0)


def test_merge_entry_point_dispatches_to_plain_on_cpu(rng):
    """ops.gm.greedy_merge_channels on CPU tensors runs the plain version:
    the same numbers, and no kernel launch."""
    arrs = [torch.as_tensor(a) for a in _pool(rng, 8, 40)]
    before = TM.launches
    got = TGM.greedy_merge_channels(*arrs, 4.0, 16, metric=0)
    ref = TM.merge_plain(*arrs, 4.0, 16, 0)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert TM.launches == before


def test_fast_prune_renormalize_matches_jax(rng):
    w = (rng.uniform(size=(6, 50)) * (rng.uniform(size=(6, 50)) < 0.7)
         * 0.01).astype(np.float32)
    w[2] = 0.0
    got = TGM.fast_prune_renormalize(torch.as_tensor(w), 1e-3)
    ref = JGM.fast_prune_renormalize(jnp.asarray(w), 1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=0)

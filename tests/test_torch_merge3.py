"""The 3-D merge kernel's plain version (``kernels/merge3.py``) against the
JAX package's XLA ``ops/gm.greedy_merge_channels3`` (``use_pallas=False``,
the route JAX takes on the CPU), on seeded disparity-space pools.

Tolerance: rtol 1e-5 / atol 1e-4 on weights and means (pixel-scale means
in the hundreds), rtol 1e-4 / atol 1e-3 on covariances: the kernel takes
its moments in one pass centred on the pick, the XLA route the mean first
and the moments about it, and the two round differently (the same bound
as the 4-D merge in tests/test_pallas.py, scaled to pixel units).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.ops import gm as JGM
from phdslam_tpu_torch.kernels import merge3 as TM3
from phdslam_tpu_torch.ops import gm as TGM

torch.set_num_threads(1)

NAMES = ("w", "m0", "m1", "m2", "c00", "c01", "c02", "c11", "c12", "c22")


def _pool(rng, P, K, zero_rows=(), ties=False):
    """Disparity-space candidates: (u, v) in a 100-pixel box so that many
    merge, d in [50, 300], random positive definite covariances."""
    w = (rng.uniform(size=(P, K)) < 0.6) * rng.uniform(0.01, 2.0, (P, K))
    if ties:                        # exact weight ties, the pick's rule
        w[:, 1::3] = w[:, 0::3][:, :w[:, 1::3].shape[1]]
        w[:, 2] = w[:, 0].max() if K > 2 else 0.0
    w[list(zero_rows)] = 0.0
    mean = np.stack([rng.uniform(300, 400, (P, K)),
                     rng.uniform(200, 300, (P, K)),
                     rng.uniform(50, 300, (P, K))])
    a = rng.normal(size=(P, K, 3, 3)) * np.array([4.0, 4.0, 20.0])[:, None]
    cov = a @ np.swapaxes(a, -1, -2) + np.diag([4.0, 4.0, 25.0])
    chans = [w, *mean] + [cov[..., i, j] for i, j in TM3.PAIRS]
    return [np.asarray(c, np.float32) for c in chans]


def _check(got, ref, tag):
    for name, g, r in zip(NAMES, got, ref):
        cov = name.startswith("c")
        np.testing.assert_allclose(
            g.numpy(), np.asarray(r), rtol=1e-4 if cov else 1e-5,
            atol=1e-3 if cov else 1e-4, err_msg=f"{tag} {name}")


@pytest.mark.parametrize("P,K,cap,sep,ties", [
    (16, 120, 64, 4.0, False),      # the shipped gate
    (9, 96, 40, 16.0, False),       # wide gate, odd P
    (8, 100, 5, 4.0, False),        # cap below the live candidates
    (12, 90, 33, 4.0, True),        # exact weight ties
])
def test_plain_merge3_matches_xla(rng, P, K, cap, sep, ties):
    arrs = _pool(rng, P, K, zero_rows=(1,), ties=ties)
    ref = JGM.greedy_merge_channels3(*(jnp.asarray(a) for a in arrs), sep,
                                     cap, use_pallas=False)
    got = TM3.merge3_plain(*(torch.as_tensor(a) for a in arrs), sep, cap)
    for g in got:
        assert g.shape == (P, cap)
    _check(got, ref, f"P={P} K={K} cap={cap}")
    # the all-zero row is an empty map: w 0, mean 0, identity covariance
    for q, name in enumerate(NAMES):
        want = 1.0 if name in ("c00", "c11", "c22") else 0.0
        np.testing.assert_array_equal(got[q][1].numpy(), want)
    if cap == 5:                    # every slot filled, mass left over
        assert bool((got[0] > 0).all(1)[[0, 2, 3]].all())
        assert float(got[0].sum()) < float(arrs[0].sum())


def test_merge3_entry_point_dispatches_to_plain_on_cpu(rng):
    """ops.gm.greedy_merge_channels3 on CPU tensors runs the plain version:
    the same numbers, and no kernel launch."""
    arrs = [torch.as_tensor(a) for a in _pool(rng, 6, 40)]
    before = TM3.launches
    got = TGM.greedy_merge_channels3(*arrs, 4.0, 16)
    ref = TM3.merge3_plain(*arrs, 4.0, 16)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert TM3.launches == before


def test_mahalanobis3_matches_inverse(rng):
    """The closed-form adjugate / determinant quadratic form is
    d^T A^-1 d (float64 numpy inverse as the oracle)."""
    a = rng.normal(size=(50, 3, 3))
    cov = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(3)
    d = rng.normal(size=(50, 3))
    ref = np.einsum("ni,nij,nj->n", d, np.linalg.inv(cov), d)
    got = TM3.mahalanobis3(
        [torch.as_tensor(cov[:, i, j]) for i, j in TM3.PAIRS],
        [torch.as_tensor(d[:, k]) for k in range(3)])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9)

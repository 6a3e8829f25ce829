"""The in-loop OSPA of the port (``ops/ospa.py::ospa_torch`` and its square
eps-scaled auction ``_auction_assign``, the plain version of
``kernels/auction.py::auction_square``) against the JAX package's
``ospa_jax`` / ``_auction_assign`` and the exact ``ospa_np``.

The auctions are compared exactly (owners) where both get the same
float32 cost array: nothing in a round is multiplied, so the same cost
gives the same bids. ``ospa_torch`` builds its cost with
``torch.linalg.vector_norm``, which may round a distance differently from
``jnp.linalg.norm``; it is held to ``tests/test_ospa.py``'s tolerances
(1e-3 against the exact value, 2e-2 at n >= 16 where the eps-optimal
auction may stop up to n * 1e-3 * c^p above the optimum, the cardinality
term 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.ops import ospa as JO
from phdslam_tpu_torch.kernels import auction as A
from phdslam_tpu_torch.ops import ospa as O

torch.set_num_threads(1)


def _cost(n, seed, kind):
    """An OSPA-shaped cost [n, n] in [0, 1] (distances over c = 5, cut at
    1), or one of quarter steps full of exact ties."""
    r = np.random.default_rng(seed)
    if kind == "ties":
        return (np.round(r.uniform(0, 1, (n, n)) * 4) / 4).astype(np.float32)
    x = r.normal(0, 8, (n, 2))
    y = r.normal(0, 8, (n, 2))
    d = np.linalg.norm(x[:, None] - y[None], axis=-1)
    return (np.minimum(d, 5.0) / 5.0).astype(np.float32)


def test_eps_schedule_matches_jax():
    n_phases = max(1, int(np.ceil(np.log(0.25 / JO._EPS_FINAL)
                                  / np.log(JO._THETA))) + 1)
    ref = jnp.asarray([JO._EPS_FINAL * JO._THETA ** (n_phases - 1 - k)
                       for k in range(n_phases)], jnp.float32)
    got = O.eps_schedule()
    assert got.dtype == torch.float32 and got.shape == (5,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (O._EPS_FINAL, O._THETA, O._BIDS_PER_N) == (
        JO._EPS_FINAL, JO._THETA, JO._BIDS_PER_N)


@pytest.mark.parametrize("kind", ["ospa", "ties"])
@pytest.mark.parametrize("max_iters", [0, 2])
@pytest.mark.parametrize("n", [1, 8, 16, 64])
def test_plain_square_auction_matches_jax(n, max_iters, kind):
    """The same float32 cost gives JAX's owners exactly, at the default
    budget and at 2 rounds a phase (the clean-up pairs the rows left)."""
    cost = _cost(n, 100 * n + max_iters, kind)
    ref = np.asarray(JO._auction_assign(jnp.asarray(cost), max_iters))
    got = O._auction_assign(torch.as_tensor(cost), max_iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert sorted(got.tolist()) == list(range(n))
    budget = max_iters or O._BIDS_PER_N * n
    owner, iters = A.auction_square_plain(torch.as_tensor(cost)[None],
                                          O.eps_schedule(), budget)
    assert torch.equal(owner[0], got) and iters.shape == (1, 5)
    if max_iters and n >= 8:
        # the budget cut the last phase short: the clean-up ran
        assert int(iters[0, -1]) == max_iters


def test_plain_square_auction_batch_equals_one_by_one():
    costs = torch.as_tensor(np.stack([_cost(16, s, "ospa")
                                      for s in range(4)]))
    eps = O.eps_schedule()
    owner, iters = A.auction_square_plain(costs, eps, 256)
    for b in range(4):
        o, it = A.auction_square_plain(costs[b:b + 1], eps, 256)
        assert torch.equal(owner[b], o[0]) and torch.equal(iters[b], it[0])


def _padded_sets(n_pad, seed, lo=None):
    """tests/test_ospa.py's random padded sets (8 slots, 1-5 and 1-6 real
    points; or n_pad slots, each set half to fully real)."""
    r = np.random.default_rng(seed)
    if lo is None:
        m_x = int(r.integers(n_pad // 2, n_pad + 1))
        m_y = int(r.integers(n_pad // 2, n_pad + 1))
        x = r.normal(0, 8, (n_pad, 2)).astype(np.float32)
        y = r.normal(0, 8, (n_pad, 2)).astype(np.float32)
    else:
        m_x, m_y = int(r.integers(1, 6)), int(r.integers(1, 7))
        x = np.zeros((n_pad, 2), np.float32)
        y = np.zeros((n_pad, 2), np.float32)
        x[:m_x] = r.normal(0, 5, (m_x, 2))
        y[:m_y] = r.normal(0, 5, (m_y, 2))
    return x, np.arange(n_pad) < m_x, y, np.arange(n_pad) < m_y, m_x, m_y


@pytest.mark.parametrize("n_pad,seed,lo,tol", [
    (8, s, 1, 1e-3) for s in range(5)] + [
    (16, 0, None, 2e-2), (16, 1, None, 2e-2), (64, 2, None, 2e-2),
    (64, 3, None, 2e-2), (256, 4, None, 2e-2)])
def test_ospa_torch_matches_np_and_jax(n_pad, seed, lo, tol):
    x, xv, y, yv, m_x, m_y = _padded_sets(n_pad, seed, lo)
    got = O.ospa_torch(torch.as_tensor(x), torch.as_tensor(xv),
                       torch.as_tensor(y), torch.as_tensor(yv), p=1.0,
                       c=5.0)
    assert all(t.shape == () and t.dtype == torch.float32 for t in got)
    ne, nl, nc = JO.ospa_np(x[:m_x], y[:m_y], p=1, c=5)
    je, jl, jc = JO.ospa_jax(jnp.asarray(x), jnp.asarray(xv),
                             jnp.asarray(y), jnp.asarray(yv), p=1.0, c=5.0)
    assert abs(float(got[0]) - ne) < tol
    assert abs(float(got[2]) - nc) < 1e-4
    assert abs(float(got[0]) - float(je)) < tol
    assert abs(float(got[1]) - float(jl)) < tol
    assert abs(float(got[2]) - float(jc)) < 1e-4


def test_ospa_torch_empty_conventions():
    """empty/empty -> (0, 0, 0) and one empty -> (c, 0, c), exactly, with
    padding or with a set of no rows."""
    z = torch.zeros((4, 2))
    f = torch.zeros(4, dtype=torch.bool)
    t = torch.ones(4, dtype=torch.bool)
    assert [float(v) for v in O.ospa_torch(z, f, z, f, c=5.0)] == [0, 0, 0]
    assert [float(v) for v in O.ospa_torch(z, f, z, t, c=5.0)] == [5, 0, 5]
    assert [float(v) for v in O.ospa_torch(z, t, z, f, c=5.0)] == [5, 0, 5]
    none = torch.zeros((0, 2))
    nv = torch.zeros(0, dtype=torch.bool)
    assert [float(v) for v in O.ospa_torch(none, nv, none, nv)] == [0, 0, 0]
    assert [float(v) for v in O.ospa_torch(none, nv, z, t, c=3.0)] == [
        3, 0, 3]
    je = JO.ospa_jax(jnp.zeros((4, 2)), jnp.zeros(4, bool), jnp.zeros((4, 2)),
                     jnp.ones(4, bool), p=1.0, c=5.0)
    assert [float(v) for v in je] == [5, 0, 5]


def test_ospa_torch_budget_stays_feasible():
    """Two rounds a phase: the clean-up completes the assignment, so the
    metric is a real (suboptimal) assignment's: no smaller than the exact
    OSPA, no larger than c."""
    x, xv, y, yv, m_x, m_y = _padded_sets(64, 7)
    got = O.ospa_torch(torch.as_tensor(x), torch.as_tensor(xv),
                       torch.as_tensor(y), torch.as_tensor(yv), p=1.0, c=5.0,
                       max_iters=2)
    ne = JO.ospa_np(x[:m_x], y[:m_y], p=1, c=5)[0]
    assert ne - 1e-5 <= float(got[0]) <= 5.0 + 1e-6

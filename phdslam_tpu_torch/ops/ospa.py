"""OSPA (Optimal SubPattern Assignment) metric on the host: the port's copy
of ``phdslam_tpu/ops/ospa.py::ospa_np``, with scipy's exact
Jonker-Volgenant assignment (the JAX package prefers its optional C++
solver when built; the optimum is the same).

  - swap so |X| = m <= n = |Y|
  - cost matrix of Euclidean distances, cut off at c before assignment
  - ospa = ((sum_assigned d^p + (n-m) c^p) / n)^(1/p)
    loc  = (sum_assigned d^p / n)^(1/p)
    card = ((n-m) c^p / n)^(1/p)
  - empty/empty -> (0, 0, 0); one empty -> (c, 0, c)
"""

from __future__ import annotations

import numpy as np


def ospa_np(x, y, p: float = 1.0, c: float = 10.0):
    """Exact OSPA of x [m, d] and y [n, d]; returns (ospa, loc, card)."""
    from scipy.optimize import linear_sum_assignment

    x = np.atleast_2d(np.asarray(x, np.float64))
    y = np.atleast_2d(np.asarray(y, np.float64))
    m, n = x.shape[0], y.shape[0]
    if m == 0 and n == 0:
        return 0.0, 0.0, 0.0
    if m == 0 or n == 0:
        return float(c), 0.0, float(c)
    if m > n:
        x, y = y, x
        m, n = n, m
    d = np.linalg.norm(x[:, None, :] - y[None, :, :], axis=-1)
    d = np.minimum(d, c)
    rows, cols = linear_sum_assignment(d ** p)
    total_loc = float((d[rows, cols] ** p).sum())
    err_cn = (c ** p * (n - m) / n) ** (1.0 / p)
    err_loc = (total_loc / n) ** (1.0 / p)
    err = ((total_loc + (n - m) * c ** p) / n) ** (1.0 / p)
    return err, err_loc, err_cn

"""Seeded candidate pools of the 2-D merge, as six float32 numpy [P, K]
channels (w, mx, my, c00, c01, c11), for tests/test_torch_merge.py and
chip_smoke.py's merge phase; and float32 pairs at the edge of the merge's
exact tests, for the proof of its gate.

- ``random_pool``: ~60 % live, means uniform in a 40 m box, random
  covariances (chip_smoke.py's ``random_pool``).
- ``course_pool``: what the benchmark's cells merge: map components
  around landmarks seen from a looping course, and births from clutter
  along it (range-bearing covariances of the shipped sensor, long and thin
  up close), ~75 % of K live.
- ``chain_pool``: per particle a chain of up to 96 components in falling
  weight, each near the next only, among random ones: the chain runs
  through the kernel's batches, each link taken or picked only once the
  one before it is settled.
- ``outlier_pool``: ``random_pool`` with reach outliers (covariances up
  to 1e6), covariances too small, near-singular or indefinite, NaN and
  infinite means and covariances, and exact weight ties; from 0 to ~60
  unbounded candidates a particle.
"""

from __future__ import annotations

import numpy as np

# the shipped sensor: range std, bearing std, range, half the field of
# view, and the births' noise factor (cfg/ackerman_synth.cfg)
STD_RANGE, STD_BEARING, MAX_RANGE, MAX_BEARING = 1.0, 0.0349, 10.0, np.pi / 2
BIRTH_NOISE = 1.5


def _f32(arrs):
    return [np.ascontiguousarray(a, dtype=np.float32) for a in arrs]


def random_pool(P, K, seed):
    rng = np.random.default_rng(seed)
    w = (rng.uniform(size=(P, K)) < 0.6) * rng.uniform(0.01, 2.0, (P, K))
    c00 = rng.uniform(0.05, 1.5, (P, K))
    c11 = rng.uniform(0.05, 1.5, (P, K))
    return _f32((w, rng.uniform(-20, 20, (P, K)),
                 rng.uniform(-20, 20, (P, K)), c00,
                 0.3 * np.sqrt(c00 * c11) * rng.uniform(-1, 1, (P, K)),
                 c11))


def _rotated(lam1, lam2, theta):
    """c00, c01, c11 of R(theta) diag(lam1, lam2) R(theta)^T."""
    c, s = np.cos(theta), np.sin(theta)
    return (lam1 * c * c + lam2 * s * s, (lam1 - lam2) * c * s,
            lam1 * s * s + lam2 * c * c)


def course_pool(P, K, seed, live=0.75):
    """Map components and births along a looping course (module doc)."""
    rng = np.random.default_rng(seed)
    n_live = int(live * K)
    out = [np.zeros((P, K)) for _ in range(6)]
    out[3][:] = 1.0
    out[5][:] = 1.0
    t = np.linspace(0.0, 2 * np.pi, 64, endpoint=False)
    for r in range(P):
        # the course: a loop of radius ~12 m, the vehicle facing along it
        rad = 12.0 + rng.normal(0, 1.0)
        px, py = rad * np.cos(t), 0.8 * rad * np.sin(t)
        head = np.arctan2(0.8 * np.cos(t), -np.sin(t))
        marks = rng.uniform(-20, 20, (80, 2))
        seen = np.hypot(marks[:, None, 0] - px, marks[:, None, 1] - py)
        marks = marks[(seen < MAX_RANGE).any(1)]
        n_map = min(n_live // 2, 4 * len(marks))
        # map components: 1-4 a landmark, tight and round-ish
        which = rng.integers(0, len(marks), n_map)
        mean_m = marks[which] + rng.normal(0, 0.3, (n_map, 2))
        cov_m = _rotated(rng.uniform(0.05, 0.6, n_map),
                         rng.uniform(0.02, 0.3, n_map),
                         rng.uniform(0, np.pi, n_map))
        w_m = rng.uniform(0.05, 1.0, n_map)
        # births: clutter and detections seen from the course
        n_b = n_live - n_map
        k = rng.integers(0, len(t), n_b)
        rr = rng.uniform(0.2, MAX_RANGE, n_b)
        bb = head[k] + rng.uniform(-MAX_BEARING, MAX_BEARING, n_b)
        mean_b = np.stack([px[k] + rr * np.cos(bb), py[k] + rr * np.sin(bb)],
                          1)
        cov_b = _rotated((BIRTH_NOISE * STD_RANGE) ** 2,
                         (BIRTH_NOISE * STD_BEARING * rr) ** 2, bb)
        w_b = rng.uniform(1e-3, 0.05, n_b)
        slots = rng.permutation(K)[:n_live]
        for c, v in enumerate((np.concatenate([w_m, w_b]),
                               *np.concatenate([mean_m, mean_b]).T,
                               *(np.concatenate([a, b]) for a, b in
                                 zip(cov_m, cov_b)))):
            out[c][r, slots] = v
    return _f32(out)


def chain_pool(P, K, seed, max_chain=96, min_sep=5.0):
    """A chain a particle in falling weight, each link near the next alone
    (metric 0 at min_sep), among random candidates (module doc)."""
    w, mx, my, c00, c01, c11 = [a.astype(np.float64)
                                for a in random_pool(P, K, seed)]
    rng = np.random.default_rng(seed + 1)
    var = 0.1                       # isotropic: near iff d^2 < min_sep var
    step = 0.85 * np.sqrt(min_sep * var)
    for r in range(P):
        n = int(rng.integers(1, min(max_chain, K // 2) + 1))
        cols = rng.permutation(K)[:n]
        x0, y0 = rng.uniform(-20, 20, 2)
        ang = rng.uniform(0, 2 * np.pi)
        d = step * np.arange(n)
        mx[r, cols] = x0 + d * np.cos(ang)
        my[r, cols] = y0 + d * np.sin(ang)
        c00[r, cols], c01[r, cols], c11[r, cols] = var, 0.0, var
        w[r, cols] = 5.0 - 4.0 * np.arange(n) / n   # above the background
    return _f32((w, mx, my, c00, c01, c11))


def outlier_pool(P, K, seed, special=True):
    """random_pool with the candidates the gate cannot bound, reach
    outliers it can, and weight ties (module doc); special=False leaves out
    the NaN and infinite ones."""
    w, mx, my, c00, c01, c11 = [a.astype(np.float64)
                                for a in random_pool(P, K, seed)]
    rng = np.random.default_rng(seed + 2)
    for r in range(P):
        n = int(rng.integers(0, 64))
        cols = rng.permutation(K)[:n]
        kind = rng.integers(0, 8 if special else 5, n)
        for c, k in zip(cols, kind):
            if k == 0:              # a reach outlier, bounded
                s = 10.0 ** rng.uniform(1, 6)
                c00[r, c], c01[r, c], c11[r, c] = s, 0.1 * s, 1.5 * s
            elif k == 1:            # too small to bound
                c00[r, c], c01[r, c], c11[r, c] = 1e-14, 0.0, 1e-14
            elif k == 2:            # singular
                a, b = rng.uniform(0.1, 1.0, 2)
                c00[r, c], c01[r, c], c11[r, c] = a, np.sqrt(a * b), b
            elif k == 3:            # indefinite
                a, b = rng.uniform(0.1, 1.0, 2)
                c00[r, c], c01[r, c], c11[r, c] = a, 1.5 * np.sqrt(a * b), b
            elif k == 4:            # a condition number past the bound
                c00[r, c], c01[r, c], c11[r, c] = 1.0, 0.0, 1e-4
            elif k == 5:
                mx[r, c] = np.nan
            elif k == 6:
                my[r, c] = np.inf if rng.uniform() < 0.5 else -np.inf
            else:
                c01[r, c] = np.nan
        w[r] = np.where(w[r] > 0, np.round(w[r] * 4) / 4 + 0.25, w[r])
    return _f32((w, mx, my, c00, c01, c11))


POOLS = dict(random=random_pool, course=course_pool, chain=chain_pool,
             outliers=outlier_pool,
             finite_outliers=lambda P, K, seed: outlier_pool(P, K, seed,
                                                             False))


def edge_pairs(n, seed, metric, min_sep, kappa):
    """n float32 pairs of bounded covariances (condition numbers up to
    kappa, both axes alike or crossed; for metric 1 mostly one covariance
    shared) whose means lie about where the
    exact test of metric turns, so that its float32 rounding decides many
    of them: (mean q [n, 2], cov q [n, 3], mean p [n, 2], cov p [n, 3]),
    covariances as (c00, c01, c11)."""
    rng = np.random.default_rng(seed)
    lam_max = 10.0 ** rng.uniform(-3, 3, (2, n))
    cond = np.exp(rng.uniform(0, np.log(kappa * 0.999), (2, n)))
    theta = rng.uniform(0, np.pi, n)
    crossed = rng.uniform(size=n) < 0.25
    thetas = [theta, np.where(crossed, theta + rng.uniform(0, np.pi, n),
                              theta)]
    covs = [np.stack(_rotated(lam_max[k], lam_max[k] / cond[k], thetas[k]),
                     1) for k in range(2)]
    if metric == 1:
        # the Hellinger test turns latest where both are alike (its
        # coefficient then 1): most pairs share one covariance
        alike = rng.uniform(size=n) < 0.75
        covs[1] = np.where(alike[:, None], covs[0], covs[1])
    s = covs[0] + covs[1]
    if metric == 0:
        a = 0.5 * s
        scale = min_sep             # d^T a^-1 d at the turn
    else:
        a = s
        scale = -4.0 * np.log(1.0 - min_sep)
    # along a's major axis, where |d|^2 / lmax(a) is largest
    tr, det = a[:, 0] + a[:, 2], a[:, 0] * a[:, 2] - a[:, 1] ** 2
    lmax = 0.5 * tr + np.sqrt(0.25 * tr * tr - det)
    ang = 0.5 * np.arctan2(2 * a[:, 1], a[:, 0] - a[:, 2])
    length = np.sqrt(scale * lmax) * rng.uniform(0.98, 1.02, n)
    origin = rng.uniform(-1e3, 1e3, (n, 2))
    d = np.stack([np.cos(ang), np.sin(ang)], 1) * length[:, None]
    return _f32((origin, covs[0], origin + d, covs[1]))

"""Small-matrix algebra and Gaussian distances of ``phdslam_tpu/ops/linalg.py``
(pure functions over batched tensors whose trailing dims are the matrix
dims), and the channelwise 4x4 Cholesky form of
``phdslam_tpu/filter/update4.py::chol4_solve_sq``. The general-d paths
solve with ``torch.linalg.*_ex``: a singular matrix gives inf or NaN, as
in JAX, without a check that would wait for the device."""

from __future__ import annotations

import functools
import math

import torch


def device_row(values, like: torch.Tensor) -> torch.Tensor:
    """The floats ``values`` as a row of ``like``'s dtype on its device,
    copied there once and cached (read-only): building it each step
    would copy from the host and make the host wait for the device."""
    return _device_row(tuple(float(v) for v in values), like.device,
                       like.dtype)


@functools.lru_cache(maxsize=64)
def _device_row(values, device, dtype):
    return torch.tensor(values, dtype=dtype, device=device)


def safe_log(x: torch.Tensor) -> torch.Tensor:
    """log(x) for x > 0, LOG0 otherwise: the lowest finite value of the
    dtype (-FLT_MAX in float32, where the config's LOG0 literal rounds to
    it)."""
    return torch.where(x > 0, torch.log(torch.clamp(x, min=1e-38)),
                       torch.finfo(x.dtype).min)


def logistic(x, lower, upper, beta, tau):
    """Generalized logistic, (upper - lower) / (1 + exp(-beta (x - tau)))."""
    return (upper - lower) / (1.0 + torch.exp(-beta * (x - tau)))


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi] with the reference's fmod-then-fold rule."""
    two_pi = 2.0 * math.pi
    r = torch.fmod(a, two_pi)
    r = torch.where(r > math.pi, r - two_pi, r)
    return torch.where(r < -math.pi, r + two_pi, r)


def det2(m):
    """Determinant of [..., 2, 2]."""
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def inv2(m, det=None):
    """Closed-form inverse of [..., 2, 2]; pass det to share it."""
    d = det2(m) if det is None else det
    inv = torch.stack([torch.stack([m[..., 1, 1], -m[..., 0, 1]], dim=-1),
                       torch.stack([-m[..., 1, 0], m[..., 0, 0]], dim=-1)],
                      dim=-2)
    return inv / d[..., None, None]


def sym2(m):
    """A 2x2 made symmetric by averaging its off-diagonals."""
    off = 0.5 * (m[..., 0, 1] + m[..., 1, 0])
    return torch.stack([torch.stack([m[..., 0, 0], off], dim=-1),
                        torch.stack([off, m[..., 1, 1]], dim=-1)], dim=-2)


def symmetrize(m):
    """(M + M^T) / 2 of [..., d, d]."""
    return 0.5 * (m + m.transpose(-1, -2))


def quadform(x, a):
    """x^T A x for [..., d] vectors and [..., d, d] matrices."""
    return torch.einsum("...i,...ij,...j->...", x, a, x)


def _solve(a, b):
    return torch.linalg.solve_ex(a, b)[0]


def mahalanobis_gaussian(mean_a, cov_a, mean_b, cov_b):
    """Squared Mahalanobis distance under the averaged covariance
    (cov_a + cov_b) / 2, as the merges use it; closed form for d = 2."""
    diff = mean_a - mean_b
    sigma = 0.5 * (cov_a + cov_b)
    if mean_a.shape[-1] == 2:
        return quadform(diff, inv2(sigma))
    sol = _solve(sigma, diff[..., None])[..., 0]
    return (diff * sol).sum(-1)


def hellinger_gaussian(mean_a, cov_a, mean_b, cov_b):
    """The reference's Hellinger-style distance, 1 - sqrt(sqrt(det(Sa Sb))
    / (det(Sa + Sb) / 2^d)) exp(-d^T (Sa + Sb)^-1 d / 4), with the identity
    in place of the inverse where det(Sa + Sb) <= FLT_MIN."""
    n = mean_a.shape[-1]
    diff = mean_a - mean_b
    sigma_sum = cov_a + cov_b
    det_sum = torch.linalg.det(sigma_sum)
    use_inv = (det_sum > 1.17549435e-38)[..., None, None]
    eye = torch.eye(n, dtype=sigma_sum.dtype, device=sigma_sum.device)
    inv_sum = inv2(sigma_sum) if n == 2 \
        else torch.linalg.inv_ex(sigma_sum)[0]
    inv_sum = torch.where(use_inv, inv_sum, eye)
    epsilon = -0.25 * quadform(diff, inv_sum)
    det_quarter = det_sum / (2.0 ** n)
    det_prod = torch.linalg.det(cov_a @ cov_b)
    dist = torch.sqrt(det_prod) / det_quarter
    return 1.0 - torch.sqrt(dist) * torch.exp(epsilon)


def gaussian_logpdf(x, mean, cov):
    """log N(x; mean, cov) for [..., d]; closed form for d = 2 (the
    determinant floored at 1e-38)."""
    n = x.shape[-1]
    diff = x - mean
    if n == 2:
        det = det2(cov)
        maha = quadform(diff, inv2(cov, det))
        return -0.5 * maha - 0.5 * torch.log(
            (2.0 * math.pi) ** n * torch.clamp(det, min=1e-38))
    logdet = torch.linalg.slogdet(cov)[1]
    sol = _solve(cov, diff[..., None])[..., 0]
    maha = (diff * sol).sum(-1)
    return -0.5 * (maha + n * math.log(2.0 * math.pi) + logdet)


def chol4_quad(a, d, eps: float = 1e-12):
    """||L^-1 d||^2 with L the Cholesky factor of the symmetric 4x4 whose
    channels a are listed in the S4 order (00, 01, 02, 03, 11, 12, 13, 22,
    23, 33), for the vector channels d (4): the Mahalanobis quadratic form,
    factored channel by channel with eps under each square root."""
    l00 = torch.sqrt(torch.clamp(a[0], min=eps))
    l10 = a[1] / l00
    l20 = a[2] / l00
    l30 = a[3] / l00
    l11 = torch.sqrt(torch.clamp(a[4] - l10 * l10, min=eps))
    l21 = (a[5] - l20 * l10) / l11
    l31 = (a[6] - l30 * l10) / l11
    l22 = torch.sqrt(torch.clamp(a[7] - l20 * l20 - l21 * l21, min=eps))
    l32 = (a[8] - l30 * l20 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(a[9] - l30 * l30 - l31 * l31 - l32 * l32,
                                 min=eps))
    y0 = d[0] / l00
    y1 = (d[1] - l10 * y0) / l11
    y2 = (d[2] - l20 * y0 - l21 * y1) / l22
    y3 = (d[3] - l30 * y0 - l31 * y1 - l32 * y2) / l33
    return y0 * y0 + y1 * y1 + y2 * y2 + y3 * y3

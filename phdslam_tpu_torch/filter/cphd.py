"""CPHD (cardinalized PHD) filter, a port of ``phdslam_tpu/filter/cphd.py``.

  constants   log factorials, the log binomial table and the Poisson clutter
              cardinality
  predict     by default a per-step Poisson prior of the in-range submap
              mass (inside ``cphd_update``); with ``cnPoissonPredict`` off,
              the log-domain convolution of the carried prior with the birth
              cardinality (``cardinality_predict``)
  births      birth Gaussians enter the map before the update, optionally
              gated to measurements no existing feature explains, with a
              binomial birth cardinality (``add_births``)
  ESF         log elementary symmetric functions of Lambda_m, full and with
              each measurement deleted: the ESF kernel (``kernels/esf.py``)
  Psi         Vo's Psi inner products with the predicted cardinality and the
              posterior cardinality (``psi_terms``)
  update      detection weights scaled by the Psi ratios, non-detection
              weights of the in-range set by (1 - pd) exp(<Psi1,cn> -
              <Psi0,cn>); the particle weight increment is <Psi0,cn>

``cphd_update`` takes the JAX package's kernel branch only: the select
kernel in raw mode (or by index under ``select_by_index``) gives the
per-measurement detection mass and the top-k1 raw terms, scaled afterwards,
and the merge kernel reduces the pool. On CPU tensors the three kernel
wrappers run their plain versions. ``esf_log``, ``esf_deleted`` and
``esf_all`` (divide and conquer) are the JAX package's -inf forms, kept as
references for the tests.

The measurements are one set for every particle or R per-run sets for R
runs blockwise on the particle axis (``filter/runs.py``); ``psi_terms``
then counts each run's measurements and keeps its [N + 1, J] masks per run
([R, 1, N + 1, J] against the [R, P, N + 1, J] terms), not per particle.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from phdslam_tpu_torch.config import STATIC_MEASUREMENT
from phdslam_tpu_torch.filter.runs import rows
from phdslam_tpu_torch.filter.state import Gaussian2DMixture
from phdslam_tpu_torch.filter.update import (gather_selected,
                                             kalman_preupdate, n_valid_of)
from phdslam_tpu_torch.kernels import esf as esf_kernel
from phdslam_tpu_torch.kernels import select
from phdslam_tpu_torch.models.measurement import predict_measurement
from phdslam_tpu_torch.ops.gm import (fast_prune_renormalize,
                                      greedy_merge_channels, top_k)
from phdslam_tpu_torch.ops.linalg import safe_log, wrap_angle

NEG_INF = -math.inf


def _log32(x: float) -> float:
    """safe_log of a float32 scalar, as a Python float."""
    return float(safe_log(torch.tensor(x, dtype=torch.float32)))


class CphdConstants(NamedTuple):
    log_factorial: torch.Tensor    # [N+1]
    log_binomial: torch.Tensor     # [N+1, N+1], [n, k] = log C(n, k)
    log_cn_clutter: torch.Tensor   # [N+1] Poisson(clutterRate) log-pmf


def make_constants(cfg, device=None) -> CphdConstants:
    return _constants(cfg.maxCardinality, float(cfg.clutterRate),
                      torch.device(device or "cpu"))


@functools.lru_cache(maxsize=8)
def _constants(max_cardinality: int, lam: float, device) -> CphdConstants:
    n = max_cardinality + 1
    ar = torch.arange(n, device=device)
    lf = torch.cumsum(torch.log(torch.clamp(ar.float(), min=1.0)), 0)
    ns, ks = ar[:, None], ar[None, :]
    lbin = torch.where(ks <= ns,
                       lf[ns] - lf[ks] - lf[torch.clamp(ns - ks, min=0)],
                       NEG_INF)
    cn_clutter = ar * _log32(lam) - lam - lf
    return CphdConstants(log_factorial=lf, log_binomial=lbin,
                         log_cn_clutter=cn_clutter)


def cardinality_predict(cn_prior, cn_birth):
    """Log-domain convolution: cn_pred[n] = lse_{j <= n} (birth[n - j] +
    prior[j]). cn_prior [..., N+1]; cn_birth broadcastable to it."""
    n = cn_prior.shape[-1]
    ar = torch.arange(n, device=cn_prior.device)
    ns, js = ar[:, None], ar[None, :]
    idx = torch.clamp(ns - js, 0, n - 1)                       # [n, j]
    full = torch.where(js <= ns, cn_birth[..., idx] + cn_prior[..., None, :],
                       NEG_INF)
    return torch.logsumexp(full, -1)


def birth_cardinality(n_births, birth_weight, consts: CphdConstants):
    """Binomial birth cardinality B(k; n, p) in the log domain; n_births
    [...] int (per particle when births are gated) -> [..., N+1]."""
    lf = consts.log_factorial
    nmax = lf.shape[0]
    k = torch.arange(nmax, device=lf.device)
    n = torch.as_tensor(n_births, device=lf.device).long()[..., None]
    at = lambda i: lf[torch.clamp(i, 0, nmax - 1)]          # clamped lookup
    lbin = at(n) - at(torch.minimum(k, n)) - at(torch.clamp(n - k, min=0))
    p = torch.tensor(birth_weight, dtype=torch.float32)
    out = lbin + k * float(safe_log(p)) + (n - k) * float(safe_log(1.0 - p))
    return torch.where(k <= n, out, NEG_INF)


def esf_log(log_lambda):
    """log-ESF coefficients [..., M+1] of {exp(log_lambda_m)} by the Vieta
    build-up; -inf entries contribute nothing."""
    m = log_lambda.shape[-1]
    e = torch.full(log_lambda.shape[:-1] + (m + 1,), NEG_INF,
                   dtype=log_lambda.dtype, device=log_lambda.device)
    e[..., 0] = 0.0
    pad = torch.full(log_lambda.shape[:-1] + (1,), NEG_INF,
                     dtype=log_lambda.dtype, device=log_lambda.device)
    for j in range(m):
        shifted = torch.cat([pad, e[..., :-1]], dim=-1)
        e = torch.logaddexp(e, log_lambda[..., j, None] + shifted)
    return e


def esf_deleted(log_lambda):
    """log-ESF with each measurement deleted: [..., M, M], entry [m, k] =
    e_k of the set without m (orders 0 .. M-1)."""
    m = log_lambda.shape[-1]
    eye = torch.eye(m, dtype=torch.bool, device=log_lambda.device)
    ll = torch.where(eye, NEG_INF, log_lambda[..., None, :])   # [..., M, M]
    return esf_log(ll)[..., :m]


def _conv_log(a, b):
    """Log-domain polynomial product: out_k = lse_i (a_i + b_{k-i});
    a [..., La], b [..., Lb] -> [..., La + Lb - 1]."""
    la, lb = a.shape[-1], b.shape[-1]
    kk = torch.arange(la + lb - 1, device=a.device)[:, None]
    jj = kk - torch.arange(la, device=a.device)[None, :]      # [K, La]
    valid = (jj >= 0) & (jj < lb)
    bj = b[..., torch.clamp(jj, 0, lb - 1)]                    # [..., K, La]
    terms = torch.where(valid, a[..., None, :] + bj, NEG_INF)
    return torch.logsumexp(terms, -1)


def esf_all(log_lambda):
    """(esf_log(ll), esf_deleted(ll)) by divide and conquer: an up-sweep of
    pairwise log-polynomial products, then a down-sweep in which each node's
    complement is its parent's complement times its sibling, so every leaf
    ends with the ESF of all other measurements. M is padded to a power of
    two with -inf (unit polynomials)."""
    m = log_lambda.shape[-1]
    mp = 1
    while mp < m:
        mp *= 2
    batch = log_lambda.shape[:-1]
    kw = dict(dtype=log_lambda.dtype, device=log_lambda.device)
    ll = torch.cat([log_lambda, torch.full(batch + (mp - m,), NEG_INF, **kw)],
                   dim=-1)
    cur = torch.cat([torch.zeros(batch + (mp, 1), **kw), ll[..., None]], -1)
    levels = [cur]
    while cur.shape[-2] > 1:
        cur = _conv_log(cur[..., 0::2, :], cur[..., 1::2, :])
        levels.append(cur)
    esf_full = cur[..., 0, :]
    comp = torch.zeros(batch + (1, 1), **kw)                  # root: unit
    for lv in range(len(levels) - 2, -1, -1):
        nodes = levels[lv]
        comp_left = _conv_log(comp, nodes[..., 1::2, :])
        comp_right = _conv_log(comp, nodes[..., 0::2, :])
        comp = torch.stack([comp_left, comp_right], dim=-2).reshape(
            batch + (nodes.shape[-2], comp_left.shape[-1]))
    return esf_full[..., :m + 1], comp[..., :m, :m]


class CphdUpdateTerms(NamedTuple):
    cn_update: torch.Tensor        # [P, N+1] posterior cardinality (log)
    log_lik: torch.Tensor          # [P] <Psi0, cn>
    scale_detect: torch.Tensor     # [P, M] log-scale of detection weights
    scale_nondetect: torch.Tensor  # [P] log-scale of non-detection weights


def psi_terms(sum_l, qdw, w, valid_mask, z_valid, cn_predict,
              consts: CphdConstants, cfg) -> CphdUpdateTerms:
    """Vo's Psi inner products. sum_l [P, M] log detection mass per
    measurement; qdw [P, F] log((1 - pd_f) w_f); w [P, F]; valid_mask
    [P, F] the in-range set; cn_predict [P, N+1] log; z_valid [M], or
    [R, M] for R runs. The measurement count stays on the device, one per
    run. The ESFs come from the ESF kernel, whose -1e30 sentinel for empty
    coefficients vanishes in every logsumexp below as -inf does.

    The terms are formed on a run view: [G, P / G, ...] for G = R runs (G =
    1 for one set), the per-run factors [G, 1, ...]."""
    P, M = sum_l.shape
    ncard = cn_predict.shape[-1]
    dev = sum_l.device
    lf, lbin = consts.log_factorial, consts.log_binomial
    cn_clut = consts.log_cn_clutter
    log_rate = _log32(cfg.clutterRate) - _log32(cfg.clutterDensity)

    log_lambda = torch.where(rows(z_valid, P, 1), sum_l + log_rate, NEG_INF)
    esf, esfd = esf_kernel.esf_all(log_lambda)           # [P, M+1], [P, M, M]
    zv = z_valid.reshape(-1, M)                          # [G, M]
    G = zv.shape[0]
    grp = lambda t: t.reshape(G, P // G, *t.shape[1:])   # [P, ...] -> runs

    # bounded log-ratio form of (n - a) log<q_D, w> - n log<1, w>
    ip_qdw = torch.clamp(torch.logsumexp(
        torch.where(valid_mask, qdw, NEG_INF), -1), min=-1e30)
    log_wsum_raw = torch.clamp(safe_log(torch.where(valid_mask, w, 0.0)
                                        .sum(-1)), min=-1e30)
    log_ratio = torch.clamp(ip_qdw - log_wsum_raw, -30.0, 0.0)     # [P]
    log_wsum = torch.clamp(log_wsum_raw, min=-30.0)

    m_count = zv.to(torch.int64).sum(-1)[:, None]                   # [G, 1]
    n_idx = torch.arange(ncard, device=dev)
    j_idx = torch.arange(M + 1, device=dev)
    mj = torch.clamp(m_count - j_idx, 0, ncard - 1)                 # [G, J]
    j_ok = j_idx <= m_count

    def psi(esf_j, shift, j_valid):
        a = j_idx + shift
        a_c = torch.clamp(a, 0, ncard - 1)
        perm = lbin[n_idx[:, None], a_c[None, :]] + lf[a_c][None, :]
        valid = (j_valid[:, None, :]
                 & (a[None, :] <= n_idx[:, None]))[:, None]  # [G,1,N+1,J]
        esf_norm = grp(esf_j - j_idx[None, :] * log_wsum[:, None])  # [G,.,J]
        aux = ((lf[mj] + cn_clut[mj])[:, None, None, :]
               + esf_norm[:, :, None, :])
        pow_term = ((n_idx[:, None] - a[None, :])
                    * grp(log_ratio)[:, :, None, None])
        terms = (aux + torch.where(valid, perm, 0.0) + pow_term
                 - shift * grp(log_wsum)[:, :, None, None])
        terms = torch.where(valid, terms, NEG_INF)
        return torch.logsumexp(terms, -1).reshape(P, ncard)       # [P, N+1]

    psi0 = psi(esf, 0, j_ok)
    psi1 = psi(esf, 1, j_ok)
    ip0 = torch.logsumexp(psi0 + cn_predict, -1)
    ip1 = torch.logsumexp(psi1 + cn_predict, -1)

    # deleted terms, reduced over n first (an exact reassociation):
    #   C[p, j] = lse_n (cn[p, n] + perm(n, j+1) + (n-j-1) log_ratio[p])
    #   ip1d[p, m] = lse_j (esfd_norm[p, m, j] + lf[m'-1-j] + cnc[m'-1-j]
    #                       + C[p, j] - log_wsum[p])
    jm = j_idx[:M]
    mj1 = torch.clamp(m_count - 1 - jm, 0, ncard - 1)               # [G, M]
    j1_ok = jm <= torch.clamp(m_count - 1, min=0)
    a1 = jm + 1
    a1_c = torch.clamp(a1, 0, ncard - 1)
    perm1 = lbin[n_idx[:, None], a1_c[None, :]] + lf[a1_c][None, :]
    valid_nj = a1[None, :] <= n_idx[:, None]                        # [N+1, M]
    pow1 = ((n_idx[None, :, None] - a1[None, None, :])
            * log_ratio[:, None, None])                             # [P, N+1, M]
    cterm = (cn_predict[:, :, None] + torch.where(valid_nj, perm1, 0.0)[None]
             + pow1)
    cterm = torch.where(valid_nj[None], cterm, NEG_INF)
    c_pj = torch.logsumexp(cterm, 1)                                # [P, M]
    esfd_norm = esfd - jm[None, None, :] * log_wsum[:, None, None]
    d_term = (grp(esfd_norm) + (lf[mj1] + cn_clut[mj1])[:, None, None, :]
              + grp(c_pj)[:, :, None, :]
              - grp(log_wsum)[:, :, None, None])              # [G, ., M, M]
    d_term = torch.where(j1_ok[:, None, None, :], d_term, NEG_INF)
    ip1d = torch.logsumexp(d_term, -1).reshape(P, M)                # [P, M]

    return CphdUpdateTerms(
        cn_update=cn_predict + psi0 - ip0[:, None], log_lik=ip0,
        scale_detect=ip1d - ip0[:, None] + log_rate,
        scale_nondetect=ip1 - ip0)


def add_births(state_map: Gaussian2DMixture, pose, z_rb, z_valid, cfg,
               consts: CphdConstants):
    """Birth Gaussians of the (previous) measurements inserted into the map
    before the update, keeping the top F by weight (ties: lower index
    first, as ``jax.lax.top_k``). Under gateBirths only measurements that no
    existing feature explains (a measurement-noise Mahalanobis gate) give
    birth. Measurements: one set, or R per-run sets ([R, M, 2], [R, M]).
    Returns (map_with_births, cn_birth [P, N+1])."""
    P, F = state_map.w.shape
    M = z_rb.shape[-2]
    zp, vp = rows(z_rb, P, 2), rows(z_valid, P, 1)
    if cfg.gateBirths:
        mean_xy = torch.stack([state_map.mx, state_map.my], dim=-1)
        r, b, _, _, _ = predict_measurement(pose[:, None, :], mean_xy)
        ir = zp[:, :, None, 0] - r[:, None, :]
        ib = wrap_angle(zp[:, :, None, 1] - b[:, None, :])
        d2 = (ir / cfg.stdRange) ** 2 + (ib / cfg.stdBearing) ** 2
        compatible = ((d2 < cfg.gateThreshold ** 2)
                      & state_map.valid[:, None, :]).any(-1)       # [P, M]
        birth_ok = vp & ~compatible
    else:
        birth_ok = vp.expand(P, M)

    theta = pose[:, None, 2] + zp[:, :, 1]
    ct, st = torch.cos(theta), torch.sin(theta)
    bdx = zp[:, :, 0] * ct
    bdy = zp[:, :, 0] * st
    var_r = (cfg.stdRange * cfg.birthNoiseFactor) ** 2
    var_b = (cfg.stdBearing * cfg.birthNoiseFactor) ** 2
    bw = torch.where(birth_ok, cfg.birthWeight, 0.0).to(state_map.w.dtype)

    top_w, idx = top_k(torch.cat([state_map.w, bw], dim=-1), F)
    take = lambda a, b: torch.gather(torch.cat([a, b], dim=-1), 1, idx)
    new_map = Gaussian2DMixture(
        w=top_w,
        mx=take(state_map.mx, pose[:, None, 0] + bdx),
        my=take(state_map.my, pose[:, None, 1] + bdy),
        c00=take(state_map.c00, ct * ct * var_r + bdy * bdy * var_b),
        c01=take(state_map.c01, ct * st * var_r - bdy * bdx * var_b),
        c11=take(state_map.c11, st * st * var_r + bdx * bdx * var_b))
    n_births = birth_ok.to(torch.int64).sum(-1)                      # [P]
    return new_map, birth_cardinality(n_births, cfg.birthWeight, consts)


def cphd_update(pose, gm: Gaussian2DMixture, cn_predict, z_rb, z_label,
                z_valid, cfg, consts: CphdConstants):
    """The CPHD measurement update: Kalman pre-update, select (raw), ESF and
    Psi terms, weight scaling, merge. cn_predict [P, N+1] is the carried
    prior, used only with ``cnPoissonPredict`` off; by default the prior is
    rebuilt as the Poisson pmf of the in-range submap's mass. Measurements:
    one set, or R per-run sets ([R, M, 2], [R, M]). Returns (map_out,
    cn_update, log_weight_delta)."""
    P, F = gm.w.shape
    M = z_rb.shape[-2]
    pre = kalman_preupdate(pose, gm, cfg)
    valid_mask = gm.w > 0
    # the Psi machinery runs on the in-range submap (rclass != 0); the
    # out-of-range features pass through with their weights unchanged
    set_mask = valid_mask & (pre.rclass != 0)
    qdw = torch.where(set_mask, safe_log(1.0 - pre.pd) + safe_log(gm.w),
                      NEG_INF)
    minw = cfg.minFeatureWeight
    k1 = min(cfg.selectTopK or (4 if cfg.mergeMode == 1 else 8), F)

    if cfg.cnPoissonPredict:
        w_sum = torch.where(set_mask, gm.w, 0.0).sum(-1)               # [P]
        n_idx = torch.arange(cn_predict.shape[-1], device=gm.w.device)
        cn_predict = (n_idx[None, :] * safe_log(w_sum)[:, None]
                      - w_sum[:, None] - consts.log_factorial[None, :])
        cn_predict = cn_predict - torch.logsumexp(cn_predict, -1,
                                                  keepdim=True)

    # raw selection: the per-measurement detection mass and the top-k1
    # unnormalised detection terms; the [P, M, F] terms are never stored
    nv = n_valid_of(z_valid) if cfg.dynamicMeasurementCount else None
    if cfg.selectByIndex:
        sum_exp, e_sel, f_sel, _ = select.fused_update_select_by_index(
            z_rb, pre, gm, cfg, k1=k1, raw=True, n_valid=nv,
            with_compat=False)
        mx_sel, my_sel, u00_sel, u01_sel, u11_sel, _ = gather_selected(
            pre, gm, z_rb, f_sel, with_lpw=False)
    else:
        (sum_exp, e_sel, mx_sel, my_sel, u00_sel, u01_sel, u11_sel, _,
         _) = select.fused_update_select(z_rb, pre, gm, cfg, k1=k1, raw=True,
                                         n_valid=nv, with_compat=False,
                                         with_lpw=False)
    vp = rows(z_valid, P, 1)
    m_ok = vp & (rows(z_label, P, 1) == STATIC_MEASUREMENT) \
        if cfg.labeledMeasurements else vp
    sum_exp = torch.where(m_ok, sum_exp, 0.0)
    e_sel = torch.where(m_ok[:, :, None], e_sel, 0.0)
    sum_l = torch.where(sum_exp > 0, safe_log(sum_exp), NEG_INF)

    terms = psi_terms(sum_l, qdw, gm.w, set_mask, z_valid, cn_predict,
                      consts, cfg)

    w_nondetect = torch.where(
        set_mask, torch.exp(qdw + terms.scale_nondetect[:, None]),
        torch.where(valid_mask, gm.w, 0.0))
    w_sec1 = torch.where(w_nondetect >= minw, w_nondetect, 0.0)
    # recombined in the log domain: exp(scale_detect) alone can overflow
    w_sel = torch.exp(safe_log(e_sel) + terms.scale_detect[:, :, None])
    w_sel = torch.where(w_sel >= minw, w_sel, 0.0)

    flat = lambda a: a.reshape(P, M * k1)
    cat = lambda a, b: torch.cat([a, flat(b)], dim=-1)
    cand_w = cat(w_sec1, w_sel)
    if cfg.mergeMode == 1:
        cand_w = fast_prune_renormalize(cand_w, cfg.mergeMinWeight)
    mw, mmx, mmy, m00, m01, m11 = greedy_merge_channels(
        cand_w, cat(gm.mx, mx_sel), cat(gm.my, my_sel), cat(gm.c00, u00_sel),
        cat(gm.c01, u01_sel), cat(gm.c11, u11_sel), cfg.minSeparation, F,
        metric=cfg.distanceMetric)
    map_out = Gaussian2DMixture(w=mw, mx=mmx, my=mmy, c00=m00, c01=m01,
                                c11=m11)
    return map_out, terms.cn_update, terms.log_lik

"""GM-PHD measurement update of the static map, fixed shapes, on tensors.

Port of ``phdslam_tpu/filter/update.py``. The update follows the JAX
package's kernel branch: the Kalman pre-update runs as [P, F] channel
arithmetic, the select kernel (``kernels/select.py``) produces the
per-measurement normalisers and the top-k1 detection terms without ever
storing the [P, M, F] likelihoods, and the merge kernel
(``kernels/merge.py``) reduces the candidate pool into the new map. On a
CPU tensor both kernel wrappers run their plain PyTorch versions.

``gather_selected`` rebuilds the payload of picked indices: the static
update runs it under ``select_by_index`` (the by-index mode of the select
kernel). ``detection_log_weights`` is the JAX package's XLA route (the
[P, M, F] tensor), kept for tests.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from phdslam_tpu_torch.config import STATIC_MEASUREMENT
from phdslam_tpu_torch.filter.state import Gaussian2DMixture
from phdslam_tpu_torch.kernels import select
from phdslam_tpu_torch.models.measurement import (predict_measurement,
                                                  range_class)
from phdslam_tpu_torch.ops.gm import (fast_prune_renormalize,
                                      greedy_merge_channels)
from phdslam_tpu_torch.ops.linalg import safe_log, wrap_angle

LOG_2PI = 1.8378770664093453


class PreUpdate(NamedTuple):
    """Measurement-independent Kalman terms, all [P, F] channels."""

    r: torch.Tensor
    bearing: torch.Tensor
    pd: torch.Tensor
    rclass: torch.Tensor         # 0 = out, 1 = in, 2 = near (0 when empty)
    g00: torch.Tensor            # Kalman gain
    g01: torch.Tensor
    g10: torch.Tensor
    g11: torch.Tensor
    u00: torch.Tensor            # Joseph-form updated covariance
    u01: torch.Tensor
    u11: torch.Tensor
    si00: torch.Tensor           # innovation covariance inverse
    si01: torch.Tensor
    si11: torch.Tensor
    log_det_s: torch.Tensor


def kalman_preupdate(pose, gm: Gaussian2DMixture, cfg) -> PreUpdate:
    """EKF terms per (particle, feature): S = J P J^T + R, K = P J^T S^-1,
    P' = (I - K J) P (I - K J)^T + K R K^T."""
    mean_xy = torch.stack([gm.mx, gm.my], dim=-1)
    r, b, dx, dy, _ = predict_measurement(pose[:, None, :], mean_xy)
    rc = range_class(r, b, cfg)
    rc = torch.where(gm.valid, rc, 0)
    in_mask = rc == 1
    pd = torch.where(in_mask, cfg.pd, 0.0).to(gm.w.dtype)

    # Slots outside the update (empty or not in range) get the benign
    # geometry dx = 1, dy = 0, so every Kalman term stays finite and no
    # 0 * inf reaches the merge's weighted sums.
    dx = torch.where(in_mask, dx, 1.0)
    dy = torch.where(in_mask, dy, 0.0)
    r2s = dx * dx + dy * dy
    rs = torch.sqrt(r2s)

    j00 = dx / rs
    j01 = dy / rs
    j10 = -dy / r2s
    j11 = dx / r2s

    p00, p01, p11 = gm.c00, gm.c01, gm.c11
    var_r = cfg.stdRange ** 2
    var_b = cfg.stdBearing ** 2

    a00 = j00 * (j00 * p00 + j01 * p01) + j01 * (j00 * p01 + j01 * p11)
    a01 = j10 * (j00 * p00 + j01 * p01) + j11 * (j00 * p01 + j01 * p11)
    a11 = j10 * (j10 * p00 + j11 * p01) + j11 * (j10 * p01 + j11 * p11)

    s00 = a00 + var_r
    s01 = a01
    s11 = a11 + var_b

    # Cancellation-free determinant: det(A + R) = det(P) / r^2
    # + a00 var_b + a11 var_r + var_r var_b, every term nonnegative, floored
    # at det(R). The naive s00 s11 - s01^2 loses everything in float32 once
    # the covariances grow.
    det_p = torch.clamp(p00 * p11 - p01 * p01, min=0.0)
    det_s = det_p / r2s + a00 * var_b + a11 * var_r + var_r * var_b
    det_s = torch.clamp(det_s, min=var_r * var_b)

    si00 = s11 / det_s
    si01 = -s01 / det_s
    si11 = s00 / det_s

    t00 = p00 * j00 + p01 * j01
    t01 = p00 * j10 + p01 * j11
    t10 = p01 * j00 + p11 * j01
    t11 = p01 * j10 + p11 * j11
    g00 = t00 * si00 + t01 * si01
    g01 = t00 * si01 + t01 * si11
    g10 = t10 * si00 + t11 * si01
    g11 = t10 * si01 + t11 * si11

    l00 = 1.0 - (g00 * j00 + g01 * j10)
    l01 = -(g00 * j01 + g01 * j11)
    l10 = -(g10 * j00 + g11 * j10)
    l11 = 1.0 - (g10 * j01 + g11 * j11)
    q00 = l00 * p00 + l01 * p01
    q01 = l00 * p01 + l01 * p11
    q10 = l10 * p00 + l11 * p01
    q11 = l10 * p01 + l11 * p11
    u00 = q00 * l00 + q01 * l01 + g00 * g00 * var_r + g01 * g01 * var_b
    u01 = q00 * l10 + q01 * l11 + g00 * g10 * var_r + g01 * g11 * var_b
    u11 = q10 * l10 + q11 * l11 + g10 * g10 * var_r + g11 * g11 * var_b

    return PreUpdate(r=r, bearing=b, pd=pd, rclass=rc, g00=g00, g01=g01,
                     g10=g10, g11=g11, u00=u00, u01=u01, u11=u11, si00=si00,
                     si01=si01, si11=si11, log_det_s=torch.log(det_s))


def detection_log_weights(pre: PreUpdate, gm: Gaussian2DMixture, z_rb,
                          z_label, z_valid, cfg):
    """log pd + log w + log N(innov; 0, S) as [P, M, F], -inf where the
    pair takes no part (the XLA route)."""
    innov_r = z_rb[None, :, None, 0] - pre.r[:, None, :]
    innov_b = wrap_angle(z_rb[None, :, None, 1] - pre.bearing[:, None, :])
    dist = (innov_r * innov_r * pre.si00[:, None, :]
            + 2.0 * innov_r * innov_b * pre.si01[:, None, :]
            + innov_b * innov_b * pre.si11[:, None, :])
    dist = torch.clamp(dist, min=0.0)
    lw = (safe_log(pre.pd)[:, None, :] + safe_log(gm.w)[:, None, :]
          - 0.5 * dist - LOG_2PI - 0.5 * pre.log_det_s[:, None, :])
    ok = (pre.rclass == 1)[:, None, :] & z_valid[None, :, None]
    if cfg.labeledMeasurements:
        ok = ok & (z_label[None, :, None] == STATIC_MEASUREMENT)
    return torch.where(ok, lw, -math.inf)


def gather_selected(pre: PreUpdate, gm: Gaussian2DMixture, z_rb, f_sel,
                    with_lpw: bool = True):
    """Payload channels of picked feature indices f_sel [P, M, k1]."""
    P, M, k1 = f_sel.shape
    F = pre.r.shape[1]
    idx = f_sel.long()
    take = lambda a: torch.gather(a[:, None, :].expand(P, M, F), 2, idx)
    ir = z_rb[None, :, None, 0] - take(pre.r)
    ib = wrap_angle(z_rb[None, :, None, 1] - take(pre.bearing))
    mx = take(gm.mx) + take(pre.g00) * ir + take(pre.g01) * ib
    my = take(gm.my) + take(pre.g10) * ir + take(pre.g11) * ib
    lpw = (safe_log(take(pre.pd)) + safe_log(take(gm.w))
           if with_lpw else None)
    return mx, my, take(pre.u00), take(pre.u01), take(pre.u11), lpw


class UpdateResult(NamedTuple):
    map_out: Gaussian2DMixture   # merged map, [P, F]
    log_weight_delta: torch.Tensor  # [P]
    w_nondetect: torch.Tensor    # [P, F]
    w_detect: torch.Tensor       # [P, M, k1] selected terms
    w_birth: torch.Tensor        # [P, M]
    det_mass: torch.Tensor       # [P, M]
    pre: PreUpdate


def n_valid_of(z_valid):
    """1 + the last valid measurement index, as a device int32 [1]."""
    M = z_valid.shape[0]
    ar = torch.arange(1, M + 1, dtype=torch.int32, device=z_valid.device)
    return torch.where(z_valid, ar, 0).max().reshape(1)


def phd_update_static(pose, gm: Gaussian2DMixture, z_rb, z_label, z_valid,
                      cfg) -> UpdateResult:
    """Static-model PHD update of all particles. pose [P, 6]; gm [P, F]
    channels; z_rb [M, 2]; z_label [M]; z_valid [M] bool."""
    F = gm.w.shape[1]
    M = z_rb.shape[0]
    k1 = min(cfg.selectTopK or (4 if cfg.mergeMode == 1 else 8), F)

    pre = kalman_preupdate(pose, gm, cfg)
    nv = n_valid_of(z_valid) if cfg.dynamicMeasurementCount else None
    if cfg.selectByIndex:
        sum_exp, w_sel, f_sel, compatible = \
            select.fused_update_select_by_index(z_rb, pre, gm, cfg, k1=k1,
                                                n_valid=nv)
        (mx_sel, my_sel, u00_sel, u01_sel, u11_sel,
         lpw_sel) = gather_selected(pre, gm, z_rb, f_sel,
                                    with_lpw=cfg.particleWeighting == 2)
    else:
        (sum_exp, w_sel, mx_sel, my_sel, u00_sel, u01_sel, u11_sel, lpw_sel,
         compatible) = select.fused_update_select(z_rb, pre, gm, cfg, k1=k1,
                                                  n_valid=nv)
    if cfg.labeledMeasurements:
        m_ok = z_valid & (z_label == STATIC_MEASUREMENT)
    else:
        m_ok = z_valid
    sum_exp = torch.where(m_ok[None, :], sum_exp, 0.0)
    w_sel = torch.where(m_ok[None, :, None], w_sel, 0.0)

    # per-measurement normalizers
    birth_w = cfg.birthWeight
    if cfg.labeledMeasurements:
        birth_ok = (z_label == STATIC_MEASUREMENT)[None, :]
    else:
        birth_ok = torch.ones((1, M), dtype=torch.bool, device=z_rb.device)
    normalizer = sum_exp + cfg.clutterDensity + birth_w
    log_norm = safe_log(normalizer)

    in_mask = pre.rclass == 1
    w_nondetect = torch.where(in_mask, gm.w * (1.0 - pre.pd), 0.0)
    if cfg.gateBirths:
        birth_ok = birth_ok & ~compatible
    w_birth = torch.where(birth_ok & z_valid[None, :], birth_w / normalizer,
                          0.0)

    # particle weighting
    mvalid = z_valid.to(gm.w.dtype)
    sum_log_norm = (log_norm * mvalid[None, :]).sum(-1)
    n_measure = mvalid.sum()
    if cfg.particleWeighting == 0:
        card_pred = (pre.pd * gm.w).sum(-1) + n_measure * birth_w
        dw = sum_log_norm - card_pred
    else:
        cn_predict = torch.where(in_mask, gm.w, 0.0).sum(-1)
        cn_update = (w_nondetect.sum(-1)
                     + (sum_exp / normalizer * mvalid[None, :]).sum(-1)
                     + (w_birth * mvalid[None, :]).sum(-1))
        dw = (n_measure * cfg.clutterDensity + cn_update - cn_predict
              - cfg.clutterRate)

    map_out = pool_merge_static_sel(
        gm, pre, w_nondetect,
        (w_sel, mx_sel, my_sel, u00_sel, u01_sel, u11_sel), w_birth, z_rb,
        pose, cfg)

    if cfg.particleWeighting == 2:
        dw = _single_feature_weighting(cfg, gm, map_out, w_sel, lpw_sel,
                                       normalizer, mx_sel, my_sel,
                                       n_measure)

    return UpdateResult(
        map_out=map_out,
        log_weight_delta=dw,
        w_nondetect=w_nondetect,
        w_detect=w_sel * mvalid[None, :, None],
        w_birth=w_birth * mvalid[None, :],
        det_mass=sum_exp / normalizer * mvalid[None, :],
        pre=pre,
    )


def pool_merge_static_sel(gm: Gaussian2DMixture, pre: PreUpdate, w_nd, sel,
                          w_birth, z_rb, pose, cfg) -> Gaussian2DMixture:
    """Prune, pool and merge into the new static map (``_pool_merge_static_
    sel`` of ``phdslam_tpu/filter/update4.py``; the static update inlines
    the same steps). The pool is [0, F) originals (non-detection terms for
    in-range features, untouched weights otherwise), [F, F + M k1) the
    selected detection terms sel = (w, mx, my, u00, u01, u11) [P, M, k1],
    then the M births."""
    w_sel, mx_sel, my_sel, u00_sel, u01_sel, u11_sel = sel
    P, F = gm.w.shape
    M, k1 = w_sel.shape[1:]
    minw = cfg.minFeatureWeight
    w_nd_p = torch.where(w_nd >= minw, w_nd, 0.0)
    w_b_p = torch.where(w_birth >= minw, w_birth, 0.0)
    w_sec1 = torch.where(pre.rclass == 1, w_nd_p, gm.w)
    w_sel = torch.where(w_sel >= minw, w_sel, 0.0)

    theta_b = pose[:, None, 2] + z_rb[None, :, 1]
    ct, st = torch.cos(theta_b), torch.sin(theta_b)
    bdx = z_rb[None, :, 0] * ct
    bdy = z_rb[None, :, 0] * st
    var_rb = (cfg.stdRange * cfg.birthNoiseFactor) ** 2
    var_bb = (cfg.stdBearing * cfg.birthNoiseFactor) ** 2

    flat = lambda a: a.reshape(P, M * k1)
    cat = lambda a, b, c: torch.cat([a, b, c], dim=-1)
    cand_w = cat(w_sec1, flat(w_sel), w_b_p)
    if cfg.mergeMode == 1:
        cand_w = fast_prune_renormalize(cand_w, cfg.mergeMinWeight)
    mw, mmx, mmy, m00, m01, m11 = greedy_merge_channels(
        cand_w,
        cat(gm.mx, flat(mx_sel), pose[:, None, 0] + bdx),
        cat(gm.my, flat(my_sel), pose[:, None, 1] + bdy),
        cat(gm.c00, flat(u00_sel), ct * ct * var_rb + bdy * bdy * var_bb),
        cat(gm.c01, flat(u01_sel), ct * st * var_rb - bdy * bdx * var_bb),
        cat(gm.c11, flat(u11_sel), st * st * var_rb + bdx * bdx * var_bb),
        cfg.minSeparation, F, metric=cfg.distanceMetric)
    return Gaussian2DMixture(w=mw, mx=mmx, my=mmy, c00=m00, c01=m01,
                             c11=m11)


def _single_feature_weighting(cfg, gm, map_out, w_sel, lpw_sel, normalizer,
                              mx_sel, my_sel, n_measure):
    """Vo single-feature weighting (particle_weighting 2): compare the
    predicted and updated PHD intensity at the updated mean of the pair
    with the highest single-object likelihood."""
    P = w_sel.shape[0]
    lik_sel = w_sel * normalizer[:, :, None] / torch.clamp(
        torch.exp(lpw_sel), min=1e-30)
    flat_lik = lik_sel.reshape(P, -1)
    best = torch.argmax(flat_lik, dim=1, keepdim=True)
    max_lik = torch.gather(flat_lik, 1, best)[:, 0]
    x_star = torch.gather(mx_sel.reshape(P, -1), 1, best)[:, 0]
    y_star = torch.gather(my_sel.reshape(P, -1), 1, best)[:, 0]

    def intensity(mix, x, y):
        dxm = x[:, None] - mix.mx
        dym = y[:, None] - mix.my
        det = torch.clamp(mix.c00 * mix.c11 - mix.c01 ** 2, min=1e-12)
        maha = (dxm * dxm * mix.c11 - 2 * dxm * dym * mix.c01
                + dym * dym * mix.c00) / det
        val = mix.w * torch.exp(-0.5 * maha) / (2.0 * math.pi
                                                * torch.sqrt(det))
        return torch.where(mix.w > 0, val, 0.0).sum(-1)

    v_predict = intensity(gm, x_star, y_star)
    v_update = intensity(map_out, x_star, y_star)
    cn_predict2 = gm.w.sum(-1)
    cn_update2 = map_out.w.sum(-1)
    a = ((1.0 - cfg.pd) * cfg.clutterDensity * n_measure
         + cfg.pd * n_measure * ((n_measure - 1.0)
                                 * cfg.clutterDensity * max_lik))
    b_fac = torch.exp(cn_update2 - cn_predict2 - cfg.clutterRate)
    return safe_log((a * v_predict)
                    / torch.clamp(b_fac * v_update, min=1e-30))


def phd_variance(result: UpdateResult, z_valid):
    """Closed-form cardinality variance of the updated map per particle:
    sum_nd w + sum_{detect, birth} w (1 - w), with the squared tail beyond
    the stored top-k1 detection terms dropped. Feeds only the logs."""
    mvalid = z_valid.to(result.w_nondetect.dtype)
    var = result.w_nondetect.sum(-1)
    det_sq = (result.w_detect ** 2).sum(-1)
    var = var + (torch.clamp(result.det_mass - det_sq, min=0.0)
                 * mvalid[None, :]).sum(-1)
    wb = result.w_birth
    return var + (wb * (1.0 - wb) * mvalid[None, :]).sum(-1)

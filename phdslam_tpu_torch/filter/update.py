"""GM-PHD measurement update of the static map, fixed shapes, on tensors.

Port of ``phdslam_tpu/filter/update.py``. The update follows the JAX
package's kernel branch: the pre-update kernel (``kalman_preupdate``,
``kernels/preupdate.py``) computes the Kalman terms as [P, F] channels,
the select kernel (``kernels/select.py``) produces the per-measurement
normalisers and the top-k1 detection terms without ever storing the
[P, M, F] likelihoods, and the merge kernel (``kernels/merge.py``) reduces
the candidate pool into the new map. On a CPU tensor the kernel wrappers
run their plain PyTorch versions.

``gather_selected`` rebuilds the payload of picked indices: the static
update runs it under ``select_by_index`` (the by-index mode of the select
kernel). ``detection_log_weights`` is the JAX package's XLA route (the
[P, M, F] tensor), kept for tests.

The measurements are one set (``z_rb [M, 2]``, ``z_label`` and ``z_valid
[M]``) for every particle, or R per-run sets (``[R, M, 2]``, ``[R, M]``) for
R runs blockwise on the particle axis (``filter/runs.py``): each
per-measurement term meets the particles through ``runs.rows``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from phdslam_tpu_torch.config import STATIC_MEASUREMENT
from phdslam_tpu_torch.filter.runs import rows
from phdslam_tpu_torch.filter.state import Gaussian2DMixture
from phdslam_tpu_torch.kernels import select
# the pre-update's kernel wrapper, under the filter's name for it
from phdslam_tpu_torch.kernels.preupdate import PreUpdate, kalman_preupdate
from phdslam_tpu_torch.ops.gm import (fast_prune_renormalize,
                                      greedy_merge_channels)
from phdslam_tpu_torch.ops.linalg import safe_log, wrap_angle
from phdslam_tpu_torch.spans import span

LOG_2PI = 1.8378770664093453


def detection_log_weights(pre: PreUpdate, gm: Gaussian2DMixture, z_rb,
                          z_label, z_valid, cfg):
    """log pd + log w + log N(innov; 0, S) as [P, M, F], -inf where the
    pair takes no part (the XLA route)."""
    P = pre.r.shape[0]
    zp = rows(z_rb, P, 2)
    innov_r = zp[:, :, None, 0] - pre.r[:, None, :]
    innov_b = wrap_angle(zp[:, :, None, 1] - pre.bearing[:, None, :])
    dist = (innov_r * innov_r * pre.si00[:, None, :]
            + 2.0 * innov_r * innov_b * pre.si01[:, None, :]
            + innov_b * innov_b * pre.si11[:, None, :])
    dist = torch.clamp(dist, min=0.0)
    lw = (safe_log(pre.pd)[:, None, :] + safe_log(gm.w)[:, None, :]
          - 0.5 * dist - LOG_2PI - 0.5 * pre.log_det_s[:, None, :])
    ok = (pre.rclass == 1)[:, None, :] & rows(z_valid, P, 1)[:, :, None]
    if cfg.labeledMeasurements:
        ok = ok & (rows(z_label, P, 1)[:, :, None] == STATIC_MEASUREMENT)
    return torch.where(ok, lw, -math.inf)


def gather_selected(pre: PreUpdate, gm: Gaussian2DMixture, z_rb, f_sel,
                    with_lpw: bool = True):
    """Payload channels of picked feature indices f_sel [P, M, k1]."""
    P, M, k1 = f_sel.shape
    F = pre.r.shape[1]
    idx = f_sel.long()
    take = lambda a: torch.gather(a[:, None, :].expand(P, M, F), 2, idx)
    zp = rows(z_rb, P, 2)
    ir = zp[:, :, None, 0] - take(pre.r)
    ib = wrap_angle(zp[:, :, None, 1] - take(pre.bearing))
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
    """1 + the last valid measurement index, as a device int32 [1] (one
    per set: [R] for z_valid [R, M])."""
    M = z_valid.shape[-1]
    ar = torch.arange(1, M + 1, dtype=torch.int32, device=z_valid.device)
    return torch.where(z_valid, ar, 0).amax(-1).reshape(-1)


def phd_update_static(pose, gm: Gaussian2DMixture, z_rb, z_label, z_valid,
                      cfg) -> UpdateResult:
    """Static-model PHD update of all particles. pose [P, 6]; gm [P, F]
    channels; z_rb [M, 2]; z_label [M]; z_valid [M] bool (or per run:
    [R, M, 2], [R, M], [R, M])."""
    P, F = gm.w.shape
    M = z_rb.shape[-2]
    k1 = min(cfg.selectTopK or (4 if cfg.mergeMode == 1 else 8), F)
    vp, lp = rows(z_valid, P, 1), rows(z_label, P, 1)      # [1 or P, M]

    with span("preupdate"):
        pre = kalman_preupdate(pose, gm, cfg)
    with span("select"):
        nv = n_valid_of(z_valid) if cfg.dynamicMeasurementCount else None
        if cfg.selectByIndex:
            sum_exp, w_sel, f_sel, compatible = \
                select.fused_update_select_by_index(z_rb, pre, gm, cfg,
                                                    k1=k1, n_valid=nv)
            (mx_sel, my_sel, u00_sel, u01_sel, u11_sel,
             lpw_sel) = gather_selected(pre, gm, z_rb, f_sel,
                                        with_lpw=cfg.particleWeighting == 2)
        else:
            (sum_exp, w_sel, mx_sel, my_sel, u00_sel, u01_sel, u11_sel,
             lpw_sel, compatible) = select.fused_update_select(
                 z_rb, pre, gm, cfg, k1=k1, n_valid=nv)
    with span("normalizers"):
        if cfg.labeledMeasurements:
            m_ok = vp & (lp == STATIC_MEASUREMENT)
        else:
            m_ok = vp
        sum_exp = torch.where(m_ok, sum_exp, 0.0)
        w_sel = torch.where(m_ok[:, :, None], w_sel, 0.0)

        # per-measurement normalizers
        birth_w = cfg.birthWeight
        if cfg.labeledMeasurements:
            birth_ok = lp == STATIC_MEASUREMENT
        else:
            birth_ok = torch.ones((1, M), dtype=torch.bool,
                                  device=z_rb.device)
        normalizer = sum_exp + cfg.clutterDensity + birth_w
        log_norm = safe_log(normalizer)

        in_mask = pre.rclass == 1
        w_nondetect = torch.where(in_mask, gm.w * (1.0 - pre.pd), 0.0)
        if cfg.gateBirths:
            birth_ok = birth_ok & ~compatible
        w_birth = torch.where(birth_ok & vp, birth_w / normalizer, 0.0)

        # particle weighting
        mvalid = vp.to(gm.w.dtype)                         # [1 or P, M]
        sum_log_norm = (log_norm * mvalid).sum(-1)
        n_measure = mvalid.sum(-1)
        if cfg.particleWeighting == 0:
            card_pred = (pre.pd * gm.w).sum(-1) + n_measure * birth_w
            dw = sum_log_norm - card_pred
        else:
            cn_predict = torch.where(in_mask, gm.w, 0.0).sum(-1)
            cn_update = (w_nondetect.sum(-1)
                         + (sum_exp / normalizer * mvalid).sum(-1)
                         + (w_birth * mvalid).sum(-1))
            dw = (n_measure * cfg.clutterDensity + cn_update - cn_predict
                  - cfg.clutterRate)
        # the terms phd_variance reads
        w_detect = w_sel * mvalid[:, :, None]
        det_mass = sum_exp / normalizer * mvalid
        w_birth_valid = w_birth * mvalid

    with span("pool"):
        pool = pool_static_sel(
            gm, pre, w_nondetect,
            (w_sel, mx_sel, my_sel, u00_sel, u01_sel, u11_sel), w_birth,
            z_rb, pose, cfg)
    with span("merge"):
        map_out = merge_pool(pool, F, cfg)

    if cfg.particleWeighting == 2:
        with span("normalizers"):
            dw = _single_feature_weighting(cfg, gm, map_out, w_sel, lpw_sel,
                                           normalizer, mx_sel, my_sel,
                                           n_measure)

    return UpdateResult(
        map_out=map_out,
        log_weight_delta=dw,
        w_nondetect=w_nondetect,
        w_detect=w_detect,
        w_birth=w_birth_valid,
        det_mass=det_mass,
        pre=pre,
    )


def pool_static_sel(gm: Gaussian2DMixture, pre: PreUpdate, w_nd, sel,
                    w_birth, z_rb, pose, cfg):
    """The pruned candidate pool as six [P, F + M k1 + M] channels (w, mx,
    my, c00, c01, c11): [0, F) originals (non-detection terms for in-range
    features, untouched weights otherwise), [F, F + M k1) the selected
    detection terms sel = (w, mx, my, u00, u01, u11) [P, M, k1], then the M
    births."""
    w_sel, mx_sel, my_sel, u00_sel, u01_sel, u11_sel = sel
    P, F = gm.w.shape
    M, k1 = w_sel.shape[1:]
    zp = rows(z_rb, P, 2)
    minw = cfg.minFeatureWeight
    w_nd_p = torch.where(w_nd >= minw, w_nd, 0.0)
    w_b_p = torch.where(w_birth >= minw, w_birth, 0.0)
    w_sec1 = torch.where(pre.rclass == 1, w_nd_p, gm.w)
    w_sel = torch.where(w_sel >= minw, w_sel, 0.0)

    theta_b = pose[:, None, 2] + zp[:, :, 1]
    ct, st = torch.cos(theta_b), torch.sin(theta_b)
    bdx = zp[:, :, 0] * ct
    bdy = zp[:, :, 0] * st
    var_rb = (cfg.stdRange * cfg.birthNoiseFactor) ** 2
    var_bb = (cfg.stdBearing * cfg.birthNoiseFactor) ** 2

    flat = lambda a: a.reshape(P, M * k1)
    cat = lambda a, b, c: torch.cat([a, b, c], dim=-1)
    cand_w = cat(w_sec1, flat(w_sel), w_b_p)
    if cfg.mergeMode == 1:
        cand_w = fast_prune_renormalize(cand_w, cfg.mergeMinWeight)
    return (cand_w,
            cat(gm.mx, flat(mx_sel), pose[:, None, 0] + bdx),
            cat(gm.my, flat(my_sel), pose[:, None, 1] + bdy),
            cat(gm.c00, flat(u00_sel), ct * ct * var_rb + bdy * bdy * var_bb),
            cat(gm.c01, flat(u01_sel), ct * st * var_rb - bdy * bdx * var_bb),
            cat(gm.c11, flat(u11_sel), st * st * var_rb + bdx * bdx * var_bb))


def merge_pool(pool, F: int, cfg) -> Gaussian2DMixture:
    """The greedy merge of ``pool_static_sel``'s six channels into the
    [P, F] map."""
    mw, mmx, mmy, m00, m01, m11 = greedy_merge_channels(
        *pool, cfg.minSeparation, F, metric=cfg.distanceMetric)
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
    mvalid = rows(z_valid, result.w_nondetect.shape[0], 1).to(
        result.w_nondetect.dtype)
    var = result.w_nondetect.sum(-1)
    det_sq = (result.w_detect ** 2).sum(-1)
    var = var + (torch.clamp(result.det_mass - det_sq, min=0.0)
                 * mvalid).sum(-1)
    wb = result.w_birth
    return var + (wb * (1.0 - wb) * mvalid).sum(-1)

"""4-D (dynamic-feature) Gaussian machinery in channel layout, and the MIXED
static + dynamic PHD update.

Port of ``phdslam_tpu/filter/update4.py``; every function keeps its JAX
name. Layouts are the JAX package's: symmetric 4x4 covariances as 10
channels on axis -2 (``[P, 10, F]``, the ``S4`` order 00 01 02 03 11 12 13
22 23 33), means as ``[P, 4, F]``.

``phd_update_mixed`` follows the JAX package's kernel branch: the static map
through the select kernel in raw mode (``kernels/select.py``), the dynamic
map through the select4 kernel (``kernels/select4.py``), one joint
normaliser per measurement, then a merge per map (``kernels/merge.py``,
``kernels/merge4.py``). Under ``select_by_index`` both selections run in
their by-index modes and the payload is gathered here. On CPU tensors every
kernel wrapper runs its plain PyTorch version.

The measurements are one set for every particle or R per-run sets
(``[R, M, 2]``, ``[R, M]``) for R runs blockwise on the particle axis
(``filter/runs.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from phdslam_tpu_torch.config import DYNAMIC_MEASUREMENT, STATIC_MEASUREMENT
from phdslam_tpu_torch.filter.runs import rows
from phdslam_tpu_torch.filter.state import Gaussian4DMixture
from phdslam_tpu_torch.filter.update import (gather_selected,
                                             kalman_preupdate, merge_pool,
                                             n_valid_of, pool_static_sel)
from phdslam_tpu_torch.kernels import _build, merge4, select, select4
from phdslam_tpu_torch.models.measurement import (predict_measurement,
                                                  range_class)
from phdslam_tpu_torch.ops.gm import fast_prune_renormalize
from phdslam_tpu_torch.ops.linalg import chol4_quad, safe_log, wrap_angle

# symmetric 4x4 channel index: (i, j) i <= j -> 0..9
S4 = {}
_k = 0
for _i in range(4):
    for _j in range(_i, 4):
        S4[(_i, _j)] = _k
        _k += 1


def s4(c, i, j):
    """Read channel (i, j) of a [..., 10, F] symmetric-4x4 stack."""
    return c[..., S4[(min(i, j), max(i, j))], :]


def chol4_solve_sq(c, d):
    """||L^-1 d||^2 for a symmetric 4x4 channel stack c [..., 10, F] and
    vector channels d [..., 4, F]: the Mahalanobis quadratic form through a
    channelwise Cholesky (eps 1e-12 under each square root)."""
    return chol4_quad([c[..., q, :] for q in range(10)],
                      [d[..., k, :] for k in range(4)])


class PreUpdate4(NamedTuple):
    r: torch.Tensor
    bearing: torch.Tensor
    pd: torch.Tensor
    rclass: torch.Tensor
    gain: torch.Tensor        # [P, 8, F] rows-major (i, a) -> 2 i + a
    cov_update: torch.Tensor  # [P, 10, F]
    si00: torch.Tensor
    si01: torch.Tensor
    si11: torch.Tensor
    log_det_s: torch.Tensor


def kalman_preupdate4(pose, gm: Gaussian4DMixture, cfg) -> PreUpdate4:
    """Channelwise 4-D EKF pre-update: range-bearing measurement of the
    position block of [x, y, vx, vy], Joseph-form covariance."""
    c = gm.cov_channels                                      # [P, 10, F]
    mean_xy = torch.stack([gm.mean_channels[..., 0, :],
                           gm.mean_channels[..., 1, :]], dim=-1)
    r, b, dx, dy, _ = predict_measurement(pose[:, None, :], mean_xy)
    rc = range_class(r, b, cfg)
    rc = torch.where(gm.w > 0, rc, 0)
    in_mask = rc == 1
    pd = torch.where(in_mask, cfg.pd, 0.0).to(gm.w.dtype)

    dx = torch.where(in_mask, dx, 1.0)
    dy = torch.where(in_mask, dy, 0.0)
    r2s = dx * dx + dy * dy
    rs = torch.sqrt(r2s)
    j00 = dx / rs
    j01 = dy / rs
    j10 = -dy / r2s
    j11 = dx / r2s
    jrows = ((j00, j01), (j10, j11))

    var_r = cfg.stdRange ** 2
    var_b = cfg.stdBearing ** 2
    p00, p01, p11 = s4(c, 0, 0), s4(c, 0, 1), s4(c, 1, 1)
    a00 = j00 * (j00 * p00 + j01 * p01) + j01 * (j00 * p01 + j01 * p11)
    a01 = j10 * (j00 * p00 + j01 * p01) + j11 * (j00 * p01 + j01 * p11)
    a11 = j10 * (j10 * p00 + j11 * p01) + j11 * (j10 * p01 + j11 * p11)
    s00, s01, s11 = a00 + var_r, a01, a11 + var_b
    det_pos = torch.clamp(p00 * p11 - p01 * p01, min=0.0)
    det_s = torch.clamp(det_pos / r2s + a00 * var_b + a11 * var_r
                        + var_r * var_b, min=var_r * var_b)
    si00, si01, si11 = s11 / det_s, -s01 / det_s, s00 / det_s
    si = ((si00, si01), (si01, si11))

    # K = P H^T J^T S^-1: T[i][a] = sum_b P[i, b] J[a][b], b in {0, 1}
    t = [[s4(c, i, 0) * jrows[a][0] + s4(c, i, 1) * jrows[a][1]
          for a in range(2)] for i in range(4)]
    gain = [[t[i][0] * si[0][a] + t[i][1] * si[1][a]
             for a in range(2)] for i in range(4)]

    # L = I - K J H: columns 0 and 1 below, columns 2 and 3 the identity
    delta = lambda i, j: 1.0 if i == j else 0.0
    lcol = [[delta(i, 0) - (gain[i][0] * j00 + gain[i][1] * j10),
             delta(i, 1) - (gain[i][0] * j01 + gain[i][1] * j11)]
            for i in range(4)]
    # Q = L P
    q = [[lcol[i][0] * s4(c, 0, j) + lcol[i][1] * s4(c, 1, j)
          + (s4(c, i, j) if i >= 2 else 0.0)
          for j in range(4)] for i in range(4)]
    # P' = Q L^T + K R K^T
    cov_up = []
    for i in range(4):
        for j in range(i, 4):
            cov_up.append(q[i][0] * lcol[j][0] + q[i][1] * lcol[j][1]
                          + (q[i][2] if j == 2 else 0.0)
                          + (q[i][3] if j == 3 else 0.0)
                          + gain[i][0] * gain[j][0] * var_r
                          + gain[i][1] * gain[j][1] * var_b)
    gain_arr = torch.stack([gain[i][a] for i in range(4) for a in range(2)],
                           dim=-2)                           # [P, 8, F]
    return PreUpdate4(
        r=r, bearing=b, pd=pd, rclass=rc, gain=gain_arr,
        cov_update=torch.stack(cov_up, dim=-2), si00=si00, si01=si01,
        si11=si11, log_det_s=torch.log(det_s))


def birth4_channels(pose, z_rb, cfg, vel=None):
    """4-D birth Gaussians: the position block from the inverse measurement,
    zero velocity mean and diag(covVxBirth, covVyBirth) velocity covariance,
    or, with vel = (vx, vy, var_v) from ``informed_birth_velocity``, that
    mean and variance. Returns mean channels [4][...], cov channels
    [10][...]."""
    rng = z_rb[..., 0]
    theta = pose[..., 2] + z_rb[..., 1]
    ct, st = torch.cos(theta), torch.sin(theta)
    bdx = rng * ct
    bdy = rng * st
    var_r = (cfg.stdRange * cfg.birthNoiseFactor) ** 2
    var_b = (cfg.stdBearing * cfg.birthNoiseFactor) ** 2
    z = torch.zeros_like(bdx)
    if vel is None:
        vx = vy = z
        vvx = torch.full_like(bdx, cfg.covVxBirth)
        vvy = torch.full_like(bdx, cfg.covVyBirth)
    else:
        vx, vy, var_v = (torch.broadcast_to(v, bdx.shape) for v in vel)
        vvx = vvy = var_v
    mean = [pose[..., 0] + bdx, pose[..., 1] + bdy, vx, vy]
    cov = [ct * ct * var_r + bdy * bdy * var_b,      # (0,0)
           ct * st * var_r - bdy * bdx * var_b,      # (0,1)
           z, z,                                      # (0,2) (0,3)
           st * st * var_r + bdx * bdx * var_b,      # (1,1)
           z, z,                                      # (1,2) (1,3)
           vvx,                                       # (2,2)
           z,                                         # (2,3)
           vvy]                                       # (3,3)
    return mean, cov


def informed_birth_velocity(pose, z_rb, z_valid, zw_prev, zp_valid, dt: float,
                            cfg):
    """Two-detection velocity initialisation of 4-D births
    (cfg.birthVelocityInit). Each measurement m is matched to the nearest
    previous-step measurement in the world frame (zw_prev [P, Mp, 2]); a
    match within 3 sigma_p + birthVelMax dt gives the observation
    v_obs = (p_m - p_prev) / dt, var_obs = 2 sigma_p^2 / dt^2, fused with
    the zero-mean covVxBirth prior. dt is a host float. Returns (vx, vy,
    var_v), each [P, M]; unmatched measurements get (0, 0, covVxBirth).
    Per run, z_rb, z_valid and zp_valid are [R, M, 2], [R, M], [R, Mp]."""
    P = pose.shape[0]
    zp, vp, vpp = rows(z_rb, P, 2), rows(z_valid, P, 1), rows(zp_valid, P, 1)
    theta = pose[:, None, 2] + zp[:, :, 1]
    px = pose[:, None, 0] + zp[:, :, 0] * torch.cos(theta)        # [P, M]
    py = pose[:, None, 1] + zp[:, :, 0] * torch.sin(theta)
    dx = px[:, :, None] - zw_prev[:, None, :, 0]                  # [P,M,Mp]
    dy = py[:, :, None] - zw_prev[:, None, :, 1]
    d2 = dx * dx + dy * dy
    d2 = torch.where(vpp[:, None, :], d2, torch.inf)
    j = torch.argmin(d2, dim=-1)                                  # [P, M]
    dmin2 = torch.amin(d2, dim=-1)
    var_p = cfg.stdRange ** 2 + (zp[:, :, 0] * cfg.stdBearing) ** 2
    r_match = 3.0 * torch.sqrt(var_p) + cfg.birthVelMax * dt
    # a zero or negative dt makes the two-point velocity undefined: no
    # match (the zero-velocity prior birth), and no division by it
    dt_safe = max(dt, 1e-6)
    matched = (dmin2 < r_match * r_match) & vp \
        & vpp.any(-1, keepdim=True) & (dt > 0.0)
    take = lambda a: torch.gather(a, 1, j)                  # [P,Mp]->[P,M]
    var_obs = 2.0 * var_p / (dt_safe * dt_safe)
    gain = cfg.covVxBirth / (cfg.covVxBirth + var_obs)
    vx = torch.where(matched,
                     gain * (px - take(zw_prev[..., 0])) / dt_safe, 0.0)
    vy = torch.where(matched,
                     gain * (py - take(zw_prev[..., 1])) / dt_safe, 0.0)
    var_v = torch.where(matched,
                        torch.clamp(gain * var_obs, min=0.1 * cfg.covVxBirth),
                        cfg.covVxBirth)
    return vx, vy, var_v


def prev_measurement_world(pose, z_prev_rb, z_prev_valid):
    """World-frame positions of the previous step's measurements at the
    pre-prediction pose: the anchors of ``informed_birth_velocity``.
    pose [P, >=3]; z_prev_rb [Mp, 2] (or [R, Mp, 2] per run); returns
    [P, Mp, 2]."""
    zp = rows(z_prev_rb, pose.shape[0], 2)
    theta = pose[:, None, 2] + zp[:, :, 1]
    x = pose[:, None, 0] + zp[:, :, 0] * torch.cos(theta)
    y = pose[:, None, 1] + zp[:, :, 0] * torch.sin(theta)
    return torch.stack([x, y], dim=-1)


def greedy_merge4(w, mean, cov, min_separation, max_out: int):
    """Channelwise 4-D greedy merge: the merge4 kernel on CUDA tensors, its
    plain version on CPU tensors. w [P, K]; mean [P, 4, K]; cov [P, 10, K].
    Returns (w [P, max_out], mean [P, 4, max_out], cov [P, 10, max_out])."""
    run = _build.kernel_for(w.device, merge4.merge4_cuda,
                            merge4.merge4_plain, "merge4")
    return run(w.contiguous(), mean.contiguous(), cov.contiguous(),
               float(min_separation), max_out)


def cv_predict4(gm: Gaussian4DMixture, cfg, dt,
                w_scale=None) -> Gaussian4DMixture:
    """Channelwise constant-velocity prediction of the dynamic map:
    mean' = F mean, cov' = F cov F^T + Q with the white-acceleration Q;
    weights optionally scaled (survival times jump-Markov)."""
    m = gm.mean_channels
    c = gm.cov_channels
    vx_var = cfg.stdAxMap ** 2
    vy_var = cfg.stdAyMap ** 2
    d2, d3, d4 = dt * dt, dt ** 3 / 2.0, dt ** 4 / 4.0
    new_m = torch.stack([
        m[..., 0, :] + dt * m[..., 2, :],
        m[..., 1, :] + dt * m[..., 3, :],
        m[..., 2, :],
        m[..., 3, :],
    ], dim=-2)
    p = lambda i, j: s4(c, i, j)
    new_c = torch.stack([
        p(0, 0) + 2 * dt * p(0, 2) + d2 * p(2, 2) + d4 * vx_var,   # 00
        p(0, 1) + dt * p(0, 3) + dt * p(1, 2) + d2 * p(2, 3),      # 01
        p(0, 2) + dt * p(2, 2) + d3 * vx_var,                      # 02
        p(0, 3) + dt * p(2, 3),                                    # 03
        p(1, 1) + 2 * dt * p(1, 3) + d2 * p(3, 3) + d4 * vy_var,   # 11
        p(1, 2) + dt * p(2, 3),                                    # 12
        p(1, 3) + dt * p(3, 3) + d3 * vy_var,                      # 13
        p(2, 2) + d2 * vx_var,                                     # 22
        p(2, 3),                                                   # 23
        p(3, 3) + d2 * vy_var,                                     # 33
    ], dim=-2)
    w = gm.w if w_scale is None else gm.w * w_scale
    return Gaussian4DMixture(w=w, mean_channels=new_m, cov_channels=new_c)


def jump_markov_scales(gm: Gaussian4DMixture, cfg):
    """Survival and jump-Markov weight factors. Returns (dynamic_scale,
    jump_weight), jump_weight = (1 - p_jmm) w the 2-D jump copies, which the
    reference computes and never re-inserts."""
    vx = gm.mean_channels[..., 2, :]
    vy = gm.mean_channels[..., 3, :]
    v_mag = torch.sqrt(vx * vx + vy * vy)
    sigmoid_v = 1.0 / (1.0 + torch.exp(cfg.beta * (cfg.tau - v_mag)))
    if cfg.featureModel == 1:  # DYNAMIC
        p_jmm = torch.ones_like(v_mag)
        ps = 1.0 - (1.0 - cfg.ps) / (1.0 + torch.exp(-cfg.beta
                                                     * (v_mag - cfg.tau)))
    else:  # MIXED
        p_jmm = sigmoid_v
        ps = torch.full_like(v_mag, cfg.ps)
    return p_jmm * ps, (1.0 - p_jmm) * gm.w


def gather_selected4(pre4: PreUpdate4, gm4: Gaussian4DMixture, z_rb, f_sel):
    """4-D analogue of ``update.gather_selected``: the detection means (via
    the gains) and updated covariances of picked slots f_sel [P, M, k1].
    Returns (mean [P, 4, M, k1], cov [P, 10, M, k1])."""
    P, M, k1 = f_sel.shape
    F = pre4.r.shape[-1]
    idx = f_sel.long()
    take_sel = lambda a: torch.gather(a[:, None, :].expand(P, M, F), 2, idx)

    def take_selc(a):                   # [P, C, F] -> [P, C, M, k1]
        C = a.shape[1]
        return torch.gather(a[:, :, None, :].expand(P, C, M, F), 3,
                            idx[:, None].expand(P, C, M, k1))

    zp = rows(z_rb, P, 2)
    ir = zp[:, :, None, 0] - take_sel(pre4.r)
    ib = wrap_angle(zp[:, :, None, 1] - take_sel(pre4.bearing))
    gk = take_selc(pre4.gain)                                  # [P,8,M,k1]
    mean_f = take_selc(gm4.mean_channels)                      # [P,4,M,k1]
    mean_det = torch.stack(
        [mean_f[:, i] + gk[:, 2 * i] * ir + gk[:, 2 * i + 1] * ib
         for i in range(4)], dim=1)
    return mean_det, take_selc(pre4.cov_update)


def phd_update_mixed(pose, gm2, gm4, z_rb, z_label, z_valid, cfg,
                     birth_vel=None):
    """MIXED-model PHD update: one normaliser per measurement over the
    static AND dynamic detection terms, static and dynamic births both
    appended (two birth terms in the normaliser when measurements are
    unlabeled), then a prune / pool / merge per map.

    pose [P, 6]; gm2 [P, F2] and gm4 [P, F4] channels; z_rb [M, 2];
    z_label [M]; z_valid [M] bool (or per run: [R, M, 2], [R, M], [R, M]).
    birth_vel: optional (vx, vy, var_v) [P, M] from
    ``informed_birth_velocity``.

    Returns (gm2_out, gm4_out, log_weight_delta [P])."""
    P, F2 = gm2.w.shape
    F4 = gm4.w.shape[-1]
    M = z_rb.shape[-2]
    dtype = gm2.w.dtype
    vp, lp = rows(z_valid, P, 1), rows(z_label, P, 1)      # [1 or P, M]
    k1 = cfg.selectTopK or (4 if cfg.mergeMode == 1 else 8)

    # static map: the select kernel in raw mode (unnormalised detection
    # values; the joint normaliser is applied below)
    pre2 = kalman_preupdate(pose, gm2, cfg)
    k1s = min(k1, F2)
    nv2 = n_valid_of(z_valid) if cfg.dynamicMeasurementCount else None
    if cfg.selectByIndex:
        sum_exp2, e_sel2, f_sel2, _ = select.fused_update_select_by_index(
            z_rb, pre2, gm2, cfg, k1=k1s, raw=True, n_valid=nv2,
            with_compat=False)
        sel2 = gather_selected(pre2, gm2, z_rb, f_sel2, with_lpw=False)[:5]
    else:
        out2 = select.fused_update_select(
            z_rb, pre2, gm2, cfg, k1=k1s, raw=True, n_valid=nv2,
            with_compat=False, with_lpw=False)
        sum_exp2, e_sel2, sel2 = out2[0], out2[1], out2[2:7]
    if cfg.labeledMeasurements:
        m_ok2 = vp & (lp == STATIC_MEASUREMENT)
    else:
        m_ok2 = vp
    sum_exp2 = torch.where(m_ok2, sum_exp2, 0.0)
    e_sel2 = torch.where(m_ok2[:, :, None], e_sel2, 0.0)

    # dynamic map: the select4 kernel (raw, every column; masked here)
    pre4 = kalman_preupdate4(pose, gm4, cfg)
    k1d = min(k1, F4)
    if cfg.selectByIndex:
        sum_exp4, e_sel4, f_sel4 = select4.fused_update_select4_by_index(
            z_rb, pre4, gm4, k1=k1d)
        mean_sel4, cov_sel4 = gather_selected4(pre4, gm4, z_rb, f_sel4)
    else:
        sum_exp4, e_sel4, mean_sel4, cov_sel4 = \
            select4.fused_update_select4(z_rb, pre4, gm4, k1=k1d)
    if cfg.labeledMeasurements:
        m_ok4 = vp & (lp == DYNAMIC_MEASUREMENT)
    else:
        m_ok4 = vp
    sum_exp4 = torch.where(m_ok4, sum_exp4, 0.0)
    e_sel4 = torch.where(m_ok4[:, :, None], e_sel4, 0.0)

    # joint per-measurement normaliser; birthWeightDynamic < 0 means the
    # symmetric births of the reference
    bw_s = cfg.birthWeight
    bw_d = cfg.birthWeightDynamic if cfg.birthWeightDynamic >= 0.0 \
        else cfg.birthWeight
    if cfg.labeledMeasurements:
        # one birth term per measurement: the labeled map's
        birth_terms = torch.where(lp == DYNAMIC_MEASUREMENT, bw_d,
                                  bw_s).to(dtype)
    else:
        birth_terms = bw_s + bw_d
    normalizer = sum_exp2 + sum_exp4 + cfg.clutterDensity + birth_terms
    log_norm = safe_log(normalizer)
    mvalid = vp.to(dtype)                                  # [1 or P, M]
    n_measure = mvalid.sum(-1)

    w_nd2 = torch.where(pre2.rclass == 1, gm2.w * (1.0 - pre2.pd), 0.0)
    w_nd4 = torch.where(pre4.rclass == 1, gm4.w * (1.0 - pre4.pd), 0.0)
    if cfg.labeledMeasurements:
        b2_ok = lp == STATIC_MEASUREMENT
        b4_ok = lp == DYNAMIC_MEASUREMENT
    else:
        b2_ok = b4_ok = torch.ones((1, M), dtype=torch.bool,
                                   device=z_rb.device)
    w_b2 = torch.where(b2_ok & vp, bw_s / normalizer, 0.0)
    w_b4 = torch.where(b4_ok & vp, bw_d / normalizer, 0.0)

    # particle weights
    sum_log_norm = (log_norm * mvalid).sum(-1)
    if cfg.particleWeighting == 0:
        # the mixed kernel's cardinality: sum pd w over both maps only
        card_pred = (pre2.pd * gm2.w).sum(-1) + (pre4.pd * gm4.w).sum(-1)
        dw = sum_log_norm - card_pred
    else:
        cn_pred = (torch.where(pre2.rclass == 1, gm2.w, 0.0).sum(-1)
                   + torch.where(pre4.rclass == 1, gm4.w, 0.0).sum(-1)
                   + n_measure * cfg.birthWeight)
        det_mass = (sum_exp2 + sum_exp4) / normalizer
        cn_up = (w_nd2.sum(-1) + w_nd4.sum(-1)
                 + (det_mass * mvalid).sum(-1)
                 + (w_b2 * mvalid).sum(-1)
                 + (w_b4 * mvalid).sum(-1))
        dw = (n_measure * cfg.clutterDensity + cn_up - cn_pred
              - cfg.clutterRate)

    scale = (1.0 / normalizer)[:, :, None]
    # the static map, pooled and merged as the static update does it
    # (phdslam_tpu/filter/update4.py::_pool_merge_static_sel)
    gm2_out = merge_pool(pool_static_sel(gm2, pre2, w_nd2,
                                         (e_sel2 * scale, *sel2), w_b2, z_rb,
                                         pose, cfg), gm2.w.shape[1], cfg)
    gm4_out = _pool_merge_dynamic_sel(gm4, w_nd4,
                                      (e_sel4 * scale, mean_sel4, cov_sel4),
                                      w_b4, z_rb, pose, cfg,
                                      birth_vel=birth_vel,
                                      rclass=pre4.rclass)
    return gm2_out, gm4_out, dw


def _pool_merge_dynamic_sel(gm4, w_nd, sel, w_birth, z_rb, pose, cfg,
                            birth_vel=None, rclass=None):
    """Dynamic-map pool and 4-D merge from the selected detection channels:
    [non-detections F | detections M k1 | births M]. Out-of-range dynamic
    features die, as in the reference, unless cfg.keepOobDynamic passes
    them through (rclass is then required)."""
    w_sel, mean_sel, cov_sel = sel       # [P,M,k1], [P,4,M,k1], [P,10,M,k1]
    P, F = gm4.w.shape
    M, k1 = w_sel.shape[1:]
    minw = cfg.minFeatureWeight
    w_sec1 = torch.where(w_nd >= minw, w_nd, 0.0)
    if cfg.keepOobDynamic:
        w_sec1 = torch.where(rclass == 1, w_sec1, gm4.w)
    w_b_p = torch.where(w_birth >= minw, w_birth, 0.0)
    w_sel = torch.where(w_sel >= minw, w_sel, 0.0)

    bm, bc = birth4_channels(pose[:, None, :], rows(z_rb, P, 2), cfg,
                             vel=birth_vel)
    mean_b = torch.stack(bm, dim=1)                             # [P, 4, M]
    cov_b = torch.stack(bc, dim=1)                              # [P, 10, M]

    flat = lambda a: a.reshape(P, M * k1)
    flatc = lambda a: a.reshape(P, a.shape[1], M * k1)
    cand_w = torch.cat([w_sec1, flat(w_sel), w_b_p], dim=-1)
    if cfg.mergeMode == 1:
        cand_w = fast_prune_renormalize(cand_w, cfg.mergeMinWeight)
    cand_mean = torch.cat([gm4.mean_channels, flatc(mean_sel), mean_b],
                          dim=-1)
    cand_cov = torch.cat([gm4.cov_channels, flatc(cov_sel), cov_b], dim=-1)
    min_sep = cfg.minSeparationDynamic \
        if cfg.minSeparationDynamic > 0 else cfg.minSeparation
    ow, om, oc = greedy_merge4(cand_w, cand_mean, cand_cov, min_sep, F)
    return Gaussian4DMixture(w=ow, mean_channels=om, cov_channels=oc)

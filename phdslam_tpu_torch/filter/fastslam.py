"""FastSLAM (filter_type = 2): per-particle EKF landmark maps with joint data
association (``phdslam_tpu/filter/fastslam.py``).

The EKF pre-update is the PHD update's channel arithmetic
(``filter/update.py::kalman_preupdate``); the association log-likelihoods
are a [P, M, F] tensor; a landmark's weight channel is its evidence counter
(+1 when associated, -1 when in view and unassociated, deleted at 0).
Association modes (``cfg.fastslamAssoc``): 1, the joint assignment by a
rectangular Jacobi auction in which every measurement also owns a private
no-match column priced at the clutter likelihood; 0, gated per-measurement
maximum likelihood with winner-takes-feature conflict resolution.

The auction runs whole in the auction kernel (``kernels/auction.py::
auction_assign``, one launch per update: the clamp of gated-out pairs, the
rounds and the column readout, the private columns never materialised).
The particle weight increment ``dw`` is the joint association
log-likelihood of the chosen assignment.

The measurements are one set for every particle or R per-run sets
(``z_rb [R, M, 2]``, ``z_valid [R, M]``) for R runs blockwise on the
particle axis (``filter/runs.py``); the auction is per particle either way.
"""

from __future__ import annotations

import math

import torch

from phdslam_tpu_torch.filter.runs import rows
from phdslam_tpu_torch.filter.state import Gaussian2DMixture
from phdslam_tpu_torch.filter.update import LOG_2PI, kalman_preupdate
from phdslam_tpu_torch.kernels import auction
from phdslam_tpu_torch.models.measurement import birth_gaussian
from phdslam_tpu_torch.ops.gm import top_k
from phdslam_tpu_torch.ops.linalg import wrap_angle

#: benefit of a gated-out or invalid pair: finite, so bids stay NaN-free
_NEG = auction.NEG
#: round budget per column
_BIDS_PER_ROW = 128


def _log_constants(cfg):
    """(log pd, log(1 - pd), log clutter density), floored as in JAX."""
    return (math.log(cfg.pd), math.log(max(1.0 - cfg.pd, 1e-12)),
            math.log(max(cfg.clutterDensity, 1e-12)))


def association_terms(pose, gm: Gaussian2DMixture, z_rb, z_valid, cfg):
    """The EKF terms and the association log-likelihood gains: (pre,
    innov_r, innov_b [P, M, F], benefit [P, M, F] (_NEG where gated out),
    in_fov [P, F])."""
    pre = kalman_preupdate(pose, gm, cfg)               # [P, F] channels
    zp = rows(z_rb, pose.shape[0], 2)
    innov_r = zp[:, :, None, 0] - pre.r[:, None, :]
    innov_b = wrap_angle(zp[:, :, None, 1] - pre.bearing[:, None, :])
    dist = (innov_r * innov_r * pre.si00[:, None, :]
            + 2.0 * innov_r * innov_b * pre.si01[:, None, :]
            + innov_b * innov_b * pre.si11[:, None, :])
    dist = torch.clamp(dist, min=0.0)
    ln_n = -0.5 * dist - LOG_2PI - 0.5 * pre.log_det_s[:, None, :]

    in_fov = (pre.rclass == 1) & gm.valid               # [P, F]
    gate_ok = ((dist <= cfg.fastslamGate) & in_fov[:, None, :]
               & rows(z_valid, pose.shape[0], 1)[:, :, None])
    log_pd, log_qd, _ = _log_constants(cfg)
    # the gain of pairing m with f over leaving both unpaired
    benefit = torch.where(gate_ok, ln_n + (log_pd - log_qd), _NEG)
    return pre, innov_r, innov_b, benefit, in_fov


def associate(benefit, z_valid, cfg):
    """(assigned [P, M], a_feat [P, M]): which measurements are paired, and
    with which feature, by the auction (fastslamAssoc 1) or by gated ML
    (0)."""
    P, M, F = benefit.shape
    dev = benefit.device
    log_kappa = _log_constants(cfg)[2]
    vp = rows(z_valid, P, 1)                            # [1 or P, M]
    if cfg.fastslamAssoc == 1:
        # JAX's _auction_rows with private no-match columns: row m may
        # always take column F + m at log kappa
        col, _ = auction.auction_assign(benefit, log_kappa,
                                        _BIDS_PER_ROW * (F + M))  # [P, M]
        return (col < F) & vp, torch.clamp(col, max=F - 1)
    # gated ML; no match where even the best feature loses to clutter
    best_f = benefit.argmax(2)                          # first of equals
    best_v = benefit.amax(2)
    assigned = (best_v > log_kappa) & vp
    # winner takes the feature: of the measurements picking one feature,
    # only the most likely keeps it
    onehot = ((best_f[:, :, None] == torch.arange(F, device=dev))
              & assigned[:, :, None])
    v_mat = torch.where(onehot, best_v[:, :, None], _NEG)
    winner = v_mat.argmax(1)                            # [P, F]
    keep = winner.gather(1, torch.clamp(best_f, max=F - 1)) \
        == torch.arange(M, device=dev)
    return assigned & keep, best_f


def fastslam_update(pose, gm: Gaussian2DMixture, z_rb, z_valid, cfg):
    """One FastSLAM measurement update over all particles.

    pose [P, 6]; gm: per-particle EKF landmark maps (w = evidence counter);
    z_rb [M, 2] padded measurements with z_valid [M] (or per run:
    [R, M, 2], [R, M]). Returns (gm_out, dw [P])."""
    P, F = gm.w.shape
    zp, vp = rows(z_rb, P, 2), rows(z_valid, P, 1)
    dev = gm.w.device
    _, log_qd, log_kappa = _log_constants(cfg)
    pre, innov_r, innov_b, benefit, in_fov = association_terms(
        pose, gm, z_rb, z_valid, cfg)
    assigned, a_feat = associate(benefit, z_valid, cfg)

    # ---- EKF update of the matched features ----
    hit = assigned[:, :, None] & (a_feat[:, :, None]
                                  == torch.arange(F, device=dev))
    ir_f = torch.where(hit, innov_r, 0.0).sum(1)        # [P, F]
    ib_f = torch.where(hit, innov_b, 0.0).sum(1)
    matched = hit.any(1)

    mx = torch.where(matched, gm.mx + pre.g00 * ir_f + pre.g01 * ib_f, gm.mx)
    my = torch.where(matched, gm.my + pre.g10 * ir_f + pre.g11 * ib_f, gm.my)
    c00 = torch.where(matched, pre.u00, gm.c00)
    c01 = torch.where(matched, pre.u01, gm.c01)
    c11 = torch.where(matched, pre.u11, gm.c11)

    # evidence counter: +1 seen, -1 missed in view, deleted at <= 0
    w = torch.where(matched, gm.w + 1.0,
                    torch.where(in_fov, gm.w - 1.0, gm.w))
    dead = w <= 0.0
    w = torch.where(dead, 0.0, w)
    c00 = torch.where(dead, 1.0, c00)
    c01 = torch.where(dead, 0.0, c01)
    c11 = torch.where(dead, 1.0, c11)
    mx = torch.where(dead, 0.0, mx)
    my = torch.where(dead, 0.0, my)

    # ---- particle weight: the joint association log-likelihood ----
    match_ben = torch.where(hit, benefit, 0.0).sum((1, 2))
    n_unmatched = (vp & ~assigned).sum(1)
    dw = (torch.where(in_fov, log_qd, 0.0).sum(1) + match_ben
          + n_unmatched.to(w.dtype) * log_kappa)

    # ---- births from the unmatched measurements ----
    bmean, bcov = birth_gaussian(pose[:, None, :], zp, cfg)
    bw = (vp & ~assigned).to(w.dtype)
    all_w = torch.cat([w, bw], dim=1)                   # [P, F + M]
    all_ch = [torch.cat([a, b], dim=1) for a, b in (
        (mx, bmean[..., 0]), (my, bmean[..., 1]), (c00, bcov[..., 0, 0]),
        (c01, bcov[..., 0, 1]), (c11, bcov[..., 1, 1]))]

    # the weight-ranked union back to F slots: existing features rank
    # ahead of births with the same count (the stable top_k)
    keep_w, idx = top_k(all_w, F)
    live = keep_w > 0.0
    kmx, kmy, k00, k01, k11 = (a.gather(1, idx) for a in all_ch)
    gm_out = Gaussian2DMixture(
        w=torch.where(live, keep_w, 0.0),
        mx=torch.where(live, kmx, 0.0), my=torch.where(live, kmy, 0.0),
        c00=torch.where(live, k00, 1.0), c01=torch.where(live, k01, 0.0),
        c11=torch.where(live, k11, 1.0))
    return gm_out, dw

"""CPU reference GM-PHD SLAM: a copy of ``phdslam_tpu/reference_cpu.py``,
kept identical apart from this docstring and the config import, so that
both packages' copies compute the same float64 results bit for bit. It is
the NumPy anchor of the port's ``bench.py`` (``vs_baseline`` when the
pinned anchor does not match) and, like the original, a dynamic-shape
implementation of the CUDA algorithm's semantics.

This is the correctness anchor the reference repo lacks (its `scphd_cpu.cpp`
is an empty stub, src/scphd_cpu.cpp:1-2). It follows the CUDA algorithm's
semantics exactly — dynamic per-particle Gaussian lists, host-style control
flow — with no padding, masking, or top-k approximations. Used by:
  * unit/regression tests as the oracle for the fixed-shape filter,
  * BASELINE config 1 ("CPU reference ... 64 particles"),
  * the speedup denominator of the benchmarks.

Algorithm mapping (all citations: the reference repository's src/):
  predict      phdfilter.cu:785-825 (Ackerman), :827-859 (CV)
  gating       phdfilter.cu:1279-1358 (in / nearly-in / out split)
  pre-update   phdfilter.cu:301-395 (Kalman terms + log partial weights)
  update       phdfilter.cu:2083-2321 (normalizers, particle weights,
                                       component weights, prune flags)
  merge        phdfilter.cu:2707-2898 (greedy max-weight moment matching)
  resample     main.cpp:453-501 (stratified with overrun backfill)

MIXED/DYNAMIC mode (cfg.featureModel in (1, 2)) adds the 4-D feature
family — the independent anchor for filter/update4.py:
  map predict  phdfilter.cu:923-1020 (CV + survival/jump-Markov scaling)
  update       phdfilter.cu:2323-2635 (phdUpdateKernelMixed: joint
               normalizer over static+dynamic detection terms, two birth
               weights when unlabeled, pd*w cardinality for weighting 0)
  4-D births   phdfilter.cu:244-299
  4-D merge    phdUpdateMergeKernel Gaussian4D overloads (Cholesky
               Mahalanobis); out-of-range dynamic features killed
               (the reference's hack, phdfilter.cu:3713-3719)

CPHD mode (cfg.filterType == 1) follows the reference's dormant CPHD
pipeline (live in src/phdfilter.cu.bak):
  births       addBirths / birthsKernel (.bak:737-856): gated births from
               the PREVIOUS step's measurements, binomial birth cardinality
  cn predict   cardinalityPredictKernel (.bak:512-545): log-pmf convolution
  pre-update   cphdPreUpdateKernel (.bak:1058-1184): per-feature pd
               (0 outside the exact FOV), qdw = log(1-pd_f) + log w over
               the in-range SUBMAP (rclass != 0) — the set every CPHD
               kernel receives (.bak:2199-2273); out-of-range features
               recombine untouched (.bak:2546-2580)
  ESF/Psi      computeEsfKernel / computePsiKernel (.bak:1194-1430)
  update       cphdUpdateKernel (.bak:1436-1478); deliberate fix: the
               non-detection scale uses the per-feature (1-pd_f) (Vo's
               equation) where the reference applies the config pd to
               every feature including out-of-FOV ones (.bak:1469-1471)
  weight       particle weight increment = <Psi0, cn> (.bak:2663-2668)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from math import lgamma
from typing import List, Optional

import numpy as np

from phdslam_tpu_torch.config import SlamConfig

LOG0 = -3.4028235e38


@dataclass
class CpuParticle:
    pose: np.ndarray                 # [6]
    log_weight: float
    w: np.ndarray                    # [F]
    mean: np.ndarray                 # [F, 2]
    cov: np.ndarray                  # [F, 2, 2]
    cn: Optional[np.ndarray] = None  # [N+1] log cardinality pmf (CPHD)
    cn_birth: Optional[np.ndarray] = None  # [N+1] log birth cardinality
    # dynamic (4-D) map, featureModel in (1, 2) — [x, y, vx, vy] features
    wd: Optional[np.ndarray] = None        # [Fd]
    mean4: Optional[np.ndarray] = None     # [Fd, 4]
    cov4: Optional[np.ndarray] = None      # [Fd, 4, 4]


@dataclass
class CpuSlam:
    particles: List[CpuParticle]
    resample_idx: np.ndarray = field(default_factory=lambda: np.zeros(0, int))

    @classmethod
    def create(cls, cfg: SlamConfig):
        n = cfg.n_particles
        pose0 = np.array([cfg.x0, cfg.y0, cfg.yaw0,
                          cfg.vx0, cfg.vy0, cfg.vyaw0], np.float64)
        if cfg.filterType == 1:        # CPHD: uniform initial cardinality
            # (main.cpp:1142 assigns -log(maxCardinality+1) to every bin)
            cn0 = np.full(cfg.maxCardinality + 1,
                          -np.log(cfg.maxCardinality + 1.0))
        else:
            cn0 = None
        dyn = cfg.featureModel in (1, 2)
        parts = [CpuParticle(pose0.copy(), -np.log(n),
                             np.zeros(0), np.zeros((0, 2)),
                             np.zeros((0, 2, 2)),
                             cn=None if cn0 is None else cn0.copy(),
                             wd=np.zeros(0) if dyn else None,
                             mean4=np.zeros((0, 4)) if dyn else None,
                             cov4=np.zeros((0, 4, 4)) if dyn else None)
                 for _ in range(n)]
        return cls(parts, np.arange(n))


def wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def predict(slam: CpuSlam, control, cfg: SlamConfig, dt, rng):
    for p in slam.particles:
        if cfg.motionType == 1:  # Ackerman
            ve = control[0] + cfg.stdEncoder * rng.standard_normal()
            al = control[1] + cfg.stdAlpha * rng.standard_normal()
            x, y, th = p.pose[0], p.pose[1], p.pose[2]
            vc = ve / (1.0 - np.tan(al) * cfg.h / cfg.l)
            td = vc * np.tan(al) / cfg.l
            p.pose[0] = x + dt * (vc * np.cos(th)
                                  - td * (cfg.a * np.sin(th)
                                          + cfg.b * np.cos(th)))
            p.pose[1] = y + dt * (vc * np.sin(th)
                                  + td * (cfg.a * np.cos(th)
                                          - cfg.b * np.sin(th)))
            p.pose[2] = wrap(th + dt * td)
            p.pose[3:] = 0.0
        else:  # CV
            ax = 3 * cfg.ax * rng.standard_normal()
            ay = 3 * cfg.ay * rng.standard_normal()
            ath = 3 * cfg.ayaw * rng.standard_normal()
            x, y, th, vx, vy, vth = p.pose
            c, s = np.cos(th), np.sin(th)
            p.pose[0] = x + dt * (vx * c - vy * s) \
                + 0.5 * dt * dt * (ax * c - ay * s)
            p.pose[1] = y + dt * (vx * s + vy * c) \
                + 0.5 * dt * dt * (ax * s + ay * c)
            p.pose[2] = wrap(th + dt * vth + 0.5 * dt * dt * ath)
            p.pose[3] = vx + dt * ax
            p.pose[4] = vy + dt * ay
            p.pose[5] = vth + dt * ath
        if p.wd is not None and len(p.wd):
            _predict_dynamic_map(p, cfg, dt)


def _predict_dynamic_map(p: CpuParticle, cfg: SlamConfig, dt):
    """CV prediction + survival/jump-Markov weight scaling of the dynamic
    map (predictMapKernelMixed, src/phdfilter.cu:923-1020; the ConstantVelocity
    motion with white-acceleration Q of device_math.cuh:608-658). Mirrors
    filter/update4.py::cv_predict4 + jump_markov_scales."""
    v = np.linalg.norm(p.mean4[:, 2:4], axis=1)
    sigmoid_v = 1.0 / (1.0 + np.exp(cfg.beta * (cfg.tau - v)))
    if cfg.featureModel == 1:        # DYNAMIC
        p_jmm = np.ones_like(v)
        ps = 1.0 - (1.0 - cfg.ps) / (1.0 + np.exp(-cfg.beta
                                                  * (v - cfg.tau)))
    else:                            # MIXED
        p_jmm = sigmoid_v
        ps = np.full_like(v, cfg.ps)
    p.wd = p.wd * p_jmm * ps
    F = np.eye(4)
    F[0, 2] = F[1, 3] = dt
    q2, q3, q4 = dt * dt, dt ** 3 / 2.0, dt ** 4 / 4.0
    Q = np.zeros((4, 4))
    Q[0, 0] = q4 * cfg.stdAxMap ** 2
    Q[1, 1] = q4 * cfg.stdAyMap ** 2
    Q[0, 2] = Q[2, 0] = q3 * cfg.stdAxMap ** 2
    Q[1, 3] = Q[3, 1] = q3 * cfg.stdAyMap ** 2
    Q[2, 2] = q2 * cfg.stdAxMap ** 2
    Q[3, 3] = q2 * cfg.stdAyMap ** 2
    p.mean4 = p.mean4 @ F.T
    p.cov4 = np.einsum("ij,fjk,lk->fil", F, p.cov4, F) + Q


def _birth(pose, z, cfg):
    theta = pose[2] + z[1]
    ct, st = np.cos(theta), np.sin(theta)
    dx, dy = z[0] * ct, z[0] * st
    mean = np.array([pose[0] + dx, pose[1] + dy])
    vr = (cfg.stdRange * cfg.birthNoiseFactor) ** 2
    vb = (cfg.stdBearing * cfg.birthNoiseFactor) ** 2
    j0, j1, j2, j3 = ct, st, -dy, dx
    cov = np.array([[j0 * j0 * vr + j2 * j2 * vb,
                     j0 * j1 * vr + j2 * j3 * vb],
                    [j0 * j1 * vr + j2 * j3 * vb,
                     j1 * j1 * vr + j3 * j3 * vb]])
    return mean, cov


def update(slam: CpuSlam, z: np.ndarray, cfg: SlamConfig):
    """z [M, 2] (range, bearing). Returns nothing; mutates particles."""
    m_count = z.shape[0]
    if m_count == 0:
        return
    var_r, var_b = cfg.stdRange ** 2, cfg.stdBearing ** 2

    for p in slam.particles:
        pose = p.pose
        # ---- gating: in / nearly-in / out ----
        if len(p.w):
            d = p.mean - pose[:2]
            r = np.linalg.norm(d, axis=1)
            b = wrap(np.arctan2(d[:, 1], d[:, 0]) - pose[2])
            in_m = (r >= cfg.minRange) & (r <= cfg.maxRange) \
                & (np.abs(b) <= cfg.maxBearing)
            near_m = ~in_m & (r >= 0.8 * cfg.minRange) \
                & (r <= 1.2 * cfg.maxRange) \
                & (np.abs(b) <= 1.2 * cfg.maxBearing)
            out_m = ~in_m & ~near_m
        else:
            in_m = near_m = out_m = np.zeros(0, bool)

        w_in, mu_in, P_in = p.w[in_m], p.mean[in_m], p.cov[in_m]
        n_f = len(w_in)

        # ---- Kalman pre-update per in-range feature ----
        comps_w, comps_mu, comps_P = [], [], []
        log_norms = np.zeros(m_count)
        sum_pd_w = 0.0
        if n_f:
            d = mu_in - pose[:2]
            r = np.linalg.norm(d, axis=1)
            bearing = wrap(np.arctan2(d[:, 1], d[:, 0]) - pose[2])
            pd = np.where((r <= cfg.maxRange)
                          & (np.abs(bearing) <= cfg.maxBearing),
                          cfg.pd, 0.0)
            sum_pd_w = float(np.sum(pd * w_in))
            J = np.stack([
                np.stack([d[:, 0] / r, d[:, 1] / r], -1),
                np.stack([-d[:, 1] / r ** 2, d[:, 0] / r ** 2], -1)], -2)
            S = np.einsum("fij,fjk,flk->fil", J, P_in, J)
            S[:, 0, 0] += var_r
            S[:, 1, 1] += var_b
            off = 0.5 * (S[:, 0, 1] + S[:, 1, 0])
            S[:, 0, 1] = S[:, 1, 0] = off
            det_s = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
            s_inv = np.stack([
                np.stack([S[:, 1, 1], -S[:, 0, 1]], -1),
                np.stack([-S[:, 1, 0], S[:, 0, 0]], -1)], -2) \
                / det_s[:, None, None]
            K = np.einsum("fij,fkj,fkl->fil", P_in, J, s_inv)
            IKJ = np.eye(2) - np.einsum("fij,fjk->fik", K, J)
            R = np.diag([var_r, var_b])
            P_up = np.einsum("fij,fjk,flk->fil", IKJ, P_in, IKJ) \
                + np.einsum("fij,jk,flk->fil", K, R, K)
            # nondetect terms
            comps_w.append(w_in * (1 - pd))
            comps_mu.append(mu_in)
            comps_P.append(P_in)
            # detection terms per measurement
            for mi in range(m_count):
                innov = np.stack([z[mi, 0] - r,
                                  wrap(z[mi, 1] - bearing)], -1)
                dist = np.einsum("fi,fij,fj->f", innov, s_inv, innov)
                lw = (np.log(pd.clip(1e-300))
                      + np.log(w_in.clip(1e-300))
                      - 0.5 * dist - np.log(2 * np.pi)
                      - 0.5 * np.log(det_s))
                sum_exp = np.exp(lw).sum()
                norm = sum_exp + cfg.clutterDensity + cfg.birthWeight
                log_norms[mi] = np.log(norm)
                comps_w.append(np.exp(lw - log_norms[mi]))
                comps_mu.append(mu_in + np.einsum("fij,fj->fi", K, innov))
                comps_P.append(P_up)
        else:
            log_norms[:] = np.log(cfg.clutterDensity + cfg.birthWeight)

        # birth terms
        bw, bmu, bP = [], [], []
        for mi in range(m_count):
            mean_b, cov_b = _birth(pose, z[mi], cfg)
            bw.append(cfg.birthWeight / np.exp(log_norms[mi]))
            bmu.append(mean_b)
            bP.append(cov_b)
        comps_w.append(np.asarray(bw))
        comps_mu.append(np.asarray(bmu))
        comps_P.append(np.asarray(bP))

        uw = np.concatenate(comps_w)
        umu = np.concatenate(comps_mu)
        uP = np.concatenate(comps_P)

        # ---- particle weight ----
        if cfg.particleWeighting == 0:
            card_pred = sum_pd_w + m_count * cfg.birthWeight
            p.log_weight += float(log_norms.sum() - card_pred)
        else:
            cn_predict = float(np.sum(w_in))
            cn_update = float(np.sum(uw))
            p.log_weight += float(m_count * cfg.clutterDensity
                                  + cn_update - cn_predict
                                  - cfg.clutterRate)

        # ---- prune ----
        keep = uw >= cfg.minFeatureWeight
        uw, umu, uP = uw[keep], umu[keep], uP[keep]

        # ---- recombine with nearly-in-range, then greedy merge ----
        uw = np.concatenate([uw, p.w[near_m]])
        umu = np.concatenate([umu, p.mean[near_m]])
        uP = np.concatenate([uP, p.cov[near_m]])

        mw, mmu, mP = _greedy_merge(uw, umu, uP, cfg)

        # ---- out-of-range pass-through ----
        p.w = np.concatenate([mw, p.w[out_m]])
        p.mean = np.concatenate([mmu, p.mean[out_m]])
        p.cov = np.concatenate([mP, p.cov[out_m]])

    # ---- weight normalization ----
    lws = np.array([p.log_weight for p in slam.particles])
    mx = lws.max()
    total = mx + np.log(np.exp(lws - mx).sum())
    for p in slam.particles:
        p.log_weight -= total


def _greedy_merge(w, mu, P, cfg: SlamConfig):
    n = len(w)
    merged_w, merged_mu, merged_P = [], [], []
    alive = w > 0
    w = w.copy()
    for _ in range(n):
        if not alive.any():
            break
        pick = np.argmax(np.where(alive, w, -1))
        refm, refP = mu[pick], P[pick]
        sig = 0.5 * (refP[None] + P)
        det = sig[:, 0, 0] * sig[:, 1, 1] - sig[:, 0, 1] * sig[:, 1, 0]
        diff = refm[None] - mu
        dist = (diff[:, 0] ** 2 * sig[:, 1, 1]
                - 2 * diff[:, 0] * diff[:, 1] * sig[:, 0, 1]
                + diff[:, 1] ** 2 * sig[:, 0, 0]) / det
        sel = alive & (dist < cfg.minSeparation)
        sel[pick] = True
        sw = w[sel]
        wsum = sw.sum()
        m = (sw[:, None] * mu[sel]).sum(0) / wsum
        dd = m[None] - mu[sel]
        cc = (sw[:, None, None]
              * (P[sel] + dd[:, :, None] * dd[:, None, :])).sum(0) / wsum
        merged_w.append(wsum)
        merged_mu.append(m)
        merged_P.append(0.5 * (cc + cc.T))
        alive &= ~sel
    if not merged_w:
        return np.zeros(0), np.zeros((0, 2)), np.zeros((0, 2, 2))
    return (np.asarray(merged_w), np.asarray(merged_mu),
            np.asarray(merged_P))


# ---------------------------------------------------------------------------
# MIXED static+dynamic model (featureModel == 2; DYNAMIC == 1 is the
# dynamic-map-only special case): dynamic-shape float64 oracle of
# phdUpdateKernelMixed (src/phdfilter.cu:2323-2635) — the independent
# anchor for the fixed-shape path in filter/update4.py.
# ---------------------------------------------------------------------------

def _birth4(pose, z, cfg):
    """4-D birth (computeBirth 4-D overload, src/phdfilter.cu:244-299):
    position block from the inverse measurement, zero velocity mean,
    diag(covVxBirth, covVyBirth) velocity covariance."""
    mean2, cov2 = _birth(pose, z, cfg)
    mean = np.concatenate([mean2, np.zeros(2)])
    cov = np.zeros((4, 4))
    cov[:2, :2] = cov2
    cov[2, 2] = cfg.covVxBirth
    cov[3, 3] = cfg.covVyBirth
    return mean, cov


def _greedy_merge4(w, mu, P, cfg: SlamConfig):
    """Greedy max-weight-first moment-matched reduction of a 4-D mixture
    (phdUpdateMergeKernel via the Gaussian4D overloads; Mahalanobis with
    averaged covariances through a Cholesky solve, gm_reduce.cpp:30-37)."""
    n = len(w)
    merged_w, merged_mu, merged_P = [], [], []
    alive = w > 0
    w = w.copy()
    for _ in range(n):
        if not alive.any():
            break
        pick = np.argmax(np.where(alive, w, -1))
        refm, refP = mu[pick], P[pick]
        sig = 0.5 * (refP[None] + P)
        diff = refm[None] - mu                      # [n, 4]
        dist = np.full(n, np.inf)
        for j in np.flatnonzero(alive):
            try:
                L = np.linalg.cholesky(sig[j])
                x = np.linalg.solve(L, diff[j])
                dist[j] = float(x @ x)
            except np.linalg.LinAlgError:
                pass
        sel = alive & (dist < cfg.minSeparation)
        sel[pick] = True
        sw = w[sel]
        wsum = sw.sum()
        m = (sw[:, None] * mu[sel]).sum(0) / wsum
        dd = m[None] - mu[sel]
        cc = (sw[:, None, None]
              * (P[sel] + dd[:, :, None] * dd[:, None, :])).sum(0) / wsum
        merged_w.append(wsum)
        merged_mu.append(m)
        merged_P.append(0.5 * (cc + cc.T))
        alive &= ~sel
    if not merged_w:
        return np.zeros(0), np.zeros((0, 4)), np.zeros((0, 4, 4))
    return (np.asarray(merged_w), np.asarray(merged_mu),
            np.asarray(merged_P))


def update_mixed(slam: CpuSlam, z: np.ndarray, cfg: SlamConfig,
                 z_label: Optional[np.ndarray] = None):
    """Mixed static+dynamic PHD update (phdUpdateKernelMixed,
    src/phdfilter.cu:2323-2635): ONE normalizer per measurement summing the
    static and dynamic detection terms plus clutter and the birth weights
    (two birth terms when measurements are unlabeled, :2501-2503); births
    into both maps; separate prune/merge per map; out-of-range dynamic
    features are killed after the update (the reference's explicit hack,
    :3713-3719). Predicted cardinality for weighting 0 is sum pd*w over
    both maps only (births contribute 0 there, :2410-2447).

    z [M, 2]; z_label [M] (0 = static, 1 = dynamic) consulted only when
    cfg.labeledMeasurements. Mutates particles."""
    m_count = z.shape[0]
    if m_count == 0:
        return
    var_r, var_b = cfg.stdRange ** 2, cfg.stdBearing ** 2
    labeled = bool(cfg.labeledMeasurements)
    if z_label is None:
        z_label = np.zeros(m_count, int)
    ones = np.ones(m_count, bool)
    st_ok = ones if not labeled else (z_label == 0)   # static dets/births
    dy_ok = ones if not labeled else (z_label == 1)   # dynamic dets/births
    # birthWeightDynamic < 0 -> symmetric (reference); >= 0 -> the dynamic
    # map births at its own weight (extension mirrored in update4.py)
    bw_s = cfg.birthWeight
    bw_d = cfg.birthWeightDynamic if cfg.birthWeightDynamic >= 0.0 \
        else cfg.birthWeight
    if labeled:
        birth_terms = np.where(z_label == 1, bw_d, bw_s)
    else:
        birth_terms = np.full(m_count, bw_s + bw_d)

    for p in slam.particles:
        pose = p.pose
        # ---- static gating: in / nearly-in / out (same as update) ----
        if len(p.w):
            d = p.mean - pose[:2]
            r = np.linalg.norm(d, axis=1)
            b = wrap(np.arctan2(d[:, 1], d[:, 0]) - pose[2])
            in_m = (r >= cfg.minRange) & (r <= cfg.maxRange) \
                & (np.abs(b) <= cfg.maxBearing)
            near_m = ~in_m & (r >= 0.8 * cfg.minRange) \
                & (r <= 1.2 * cfg.maxRange) \
                & (np.abs(b) <= 1.2 * cfg.maxBearing)
            out_m = ~in_m & ~near_m
        else:
            in_m = near_m = out_m = np.zeros(0, bool)
        w_in, mu_in, P_in = p.w[in_m], p.mean[in_m], p.cov[in_m]

        # ---- dynamic gating: in-range survives, everything else dies ----
        if len(p.wd):
            d4 = p.mean4[:, :2] - pose[:2]
            r4 = np.linalg.norm(d4, axis=1)
            b4 = wrap(np.arctan2(d4[:, 1], d4[:, 0]) - pose[2])
            in4 = (r4 >= cfg.minRange) & (r4 <= cfg.maxRange) \
                & (np.abs(b4) <= cfg.maxBearing)
        else:
            in4 = np.zeros(0, bool)
        wd_in = p.wd[in4]
        mu4_in = p.mean4[in4]
        P4_in = p.cov4[in4]
        n2, n4 = len(w_in), len(wd_in)

        # ---- static pre-update ----
        if n2:
            d = mu_in - pose[:2]
            r2 = np.linalg.norm(d, axis=1)
            bearing2 = wrap(np.arctan2(d[:, 1], d[:, 0]) - pose[2])
            pd2 = np.where((r2 <= cfg.maxRange)
                           & (np.abs(bearing2) <= cfg.maxBearing),
                           cfg.pd, 0.0)
            J = np.stack([
                np.stack([d[:, 0] / r2, d[:, 1] / r2], -1),
                np.stack([-d[:, 1] / r2 ** 2, d[:, 0] / r2 ** 2], -1)], -2)
            S = np.einsum("fij,fjk,flk->fil", J, P_in, J)
            S[:, 0, 0] += var_r
            S[:, 1, 1] += var_b
            off = 0.5 * (S[:, 0, 1] + S[:, 1, 0])
            S[:, 0, 1] = S[:, 1, 0] = off
            det_s2 = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
            s_inv2 = np.stack([
                np.stack([S[:, 1, 1], -S[:, 0, 1]], -1),
                np.stack([-S[:, 1, 0], S[:, 0, 0]], -1)], -2) \
                / det_s2[:, None, None]
            K2 = np.einsum("fij,fkj,fkl->fil", P_in, J, s_inv2)
            IKJ = np.eye(2) - np.einsum("fij,fjk->fik", K2, J)
            R = np.diag([var_r, var_b])
            P_up2 = np.einsum("fij,fjk,flk->fil", IKJ, P_in, IKJ) \
                + np.einsum("fij,jk,flk->fil", K2, R, K2)
        else:
            pd2 = np.zeros(0)

        # ---- dynamic pre-update: H = J [I2 | 0] ----
        if n4:
            d = mu4_in[:, :2] - pose[:2]
            r = np.linalg.norm(d, axis=1)
            bearing4 = wrap(np.arctan2(d[:, 1], d[:, 0]) - pose[2])
            pd4 = np.full(n4, cfg.pd)    # in-range by construction
            J4 = np.stack([
                np.stack([d[:, 0] / r, d[:, 1] / r], -1),
                np.stack([-d[:, 1] / r ** 2, d[:, 0] / r ** 2], -1)], -2)
            H = np.zeros((n4, 2, 4))
            H[:, :, :2] = J4
            S4m = np.einsum("fij,fjk,flk->fil", H, P4_in, H)
            S4m[:, 0, 0] += var_r
            S4m[:, 1, 1] += var_b
            off = 0.5 * (S4m[:, 0, 1] + S4m[:, 1, 0])
            S4m[:, 0, 1] = S4m[:, 1, 0] = off
            det_s4 = S4m[:, 0, 0] * S4m[:, 1, 1] \
                - S4m[:, 0, 1] * S4m[:, 1, 0]
            s_inv4 = np.stack([
                np.stack([S4m[:, 1, 1], -S4m[:, 0, 1]], -1),
                np.stack([-S4m[:, 1, 0], S4m[:, 0, 0]], -1)], -2) \
                / det_s4[:, None, None]
            K4 = np.einsum("fij,fkj,fkl->fil", P4_in, H, s_inv4)
            IKH = np.eye(4) - np.einsum("fij,fjk->fik", K4, H)
            R = np.diag([var_r, var_b])
            P_up4 = np.einsum("fij,fjk,flk->fil", IKH, P4_in, IKH) \
                + np.einsum("fij,jk,flk->fil", K4, R, K4)
        else:
            pd4 = np.zeros(0)

        # ---- joint normalizers + component terms ----
        comps_w2 = [w_in * (1 - pd2)] if n2 else []
        comps_mu2 = [mu_in] if n2 else []
        comps_P2 = [P_in] if n2 else []
        comps_w4 = [wd_in * (1 - pd4)] if n4 else []
        comps_mu4 = [mu4_in] if n4 else []
        comps_P4 = [P4_in] if n4 else []
        log_norms = np.zeros(m_count)
        for mi in range(m_count):
            sum2 = 0.0
            sum4 = 0.0
            if n2 and st_ok[mi]:
                innov2 = np.stack([z[mi, 0] - r2,
                                   wrap(z[mi, 1] - bearing2)], -1)
                dist2 = np.einsum("fi,fij,fj->f", innov2, s_inv2, innov2)
                lw2 = (np.log(pd2.clip(1e-300))
                       + np.log(w_in.clip(1e-300))
                       - 0.5 * dist2 - np.log(2 * np.pi)
                       - 0.5 * np.log(det_s2))
                sum2 = np.exp(lw2).sum()
            if n4 and dy_ok[mi]:
                innov4 = np.stack([
                    z[mi, 0] - np.linalg.norm(mu4_in[:, :2] - pose[:2],
                                              axis=1),
                    wrap(z[mi, 1] - bearing4)], -1)
                dist4 = np.einsum("fi,fij,fj->f", innov4, s_inv4, innov4)
                lw4 = (np.log(pd4.clip(1e-300))
                       + np.log(wd_in.clip(1e-300))
                       - 0.5 * dist4 - np.log(2 * np.pi)
                       - 0.5 * np.log(det_s4))
                sum4 = np.exp(lw4).sum()
            norm = (sum2 + sum4 + cfg.clutterDensity
                    + birth_terms[mi])
            log_norms[mi] = np.log(norm)
            if n2 and st_ok[mi]:
                comps_w2.append(np.exp(lw2 - log_norms[mi]))
                comps_mu2.append(
                    mu_in + np.einsum("fij,fj->fi", K2, innov2))
                comps_P2.append(P_up2)
            if n4 and dy_ok[mi]:
                comps_w4.append(np.exp(lw4 - log_norms[mi]))
                comps_mu4.append(
                    mu4_in + np.einsum("fij,fj->fi", K4, innov4))
                comps_P4.append(P_up4)

        # births into both maps
        for mi in range(m_count):
            if st_ok[mi]:
                mean_b, cov_b = _birth(pose, z[mi], cfg)
                comps_w2.append(
                    np.array([bw_s / np.exp(log_norms[mi])]))
                comps_mu2.append(mean_b[None])
                comps_P2.append(cov_b[None])
            if dy_ok[mi]:
                mean_b4, cov_b4 = _birth4(pose, z[mi], cfg)
                comps_w4.append(
                    np.array([bw_d / np.exp(log_norms[mi])]))
                comps_mu4.append(mean_b4[None])
                comps_P4.append(cov_b4[None])

        uw2 = np.concatenate(comps_w2) if comps_w2 else np.zeros(0)
        umu2 = np.concatenate(comps_mu2) if comps_mu2 else np.zeros((0, 2))
        uP2 = np.concatenate(comps_P2) if comps_P2 else np.zeros((0, 2, 2))
        uw4 = np.concatenate(comps_w4) if comps_w4 else np.zeros(0)
        umu4 = np.concatenate(comps_mu4) if comps_mu4 else np.zeros((0, 4))
        uP4 = np.concatenate(comps_P4) if comps_P4 else np.zeros((0, 4, 4))

        # ---- particle weight ----
        if cfg.particleWeighting == 0:
            card_pred = float(np.sum(pd2 * w_in) + np.sum(pd4 * wd_in))
            p.log_weight += float(log_norms.sum() - card_pred)
        else:
            cn_predict = float(np.sum(w_in) + np.sum(wd_in)
                               + m_count * cfg.birthWeight)
            cn_update = float(np.sum(uw2) + np.sum(uw4))
            p.log_weight += float(m_count * cfg.clutterDensity
                                  + cn_update - cn_predict
                                  - cfg.clutterRate)

        # ---- prune ----
        keep2 = uw2 >= cfg.minFeatureWeight
        uw2, umu2, uP2 = uw2[keep2], umu2[keep2], uP2[keep2]
        keep4 = uw4 >= cfg.minFeatureWeight
        uw4, umu4, uP4 = uw4[keep4], umu4[keep4], uP4[keep4]

        # ---- static: recombine nearly-in, merge, out passes through ----
        uw2 = np.concatenate([uw2, p.w[near_m]])
        umu2 = np.concatenate([umu2, p.mean[near_m]])
        uP2 = np.concatenate([uP2, p.cov[near_m]])
        mw2, mmu2, mP2 = _greedy_merge(uw2, umu2, uP2, cfg)
        p.w = np.concatenate([mw2, p.w[out_m]])
        p.mean = np.concatenate([mmu2, p.mean[out_m]])
        p.cov = np.concatenate([mP2, p.cov[out_m]])

        # ---- dynamic: merge only (out-of-range already killed) ----
        p.wd, p.mean4, p.cov4 = _greedy_merge4(uw4, umu4, uP4, cfg)

    # ---- weight normalization ----
    lws = np.array([p.log_weight for p in slam.particles])
    mx = lws.max()
    total = mx + np.log(np.exp(lws - mx).sum())
    for p in slam.particles:
        p.log_weight -= total


# ---------------------------------------------------------------------------
# CPHD (filterType == 1): dynamic-shape float64 oracle of the reference's
# dormant CPHD pipeline (src/phdfilter.cu.bak). Everything runs per
# particle with plain Python/NumPy control flow — the independent anchor
# for the fixed-shape path in filter/cphd.py.
# ---------------------------------------------------------------------------

def _logsumexp(a, axis=None):
    from scipy.special import logsumexp
    with np.errstate(invalid="ignore"):
        out = logsumexp(a, axis=axis)
    return np.where(np.isnan(out), -np.inf, out) if np.ndim(out) else \
        (-np.inf if np.isnan(out) else out)


def _cphd_add_births(p: CpuParticle, z_prev, cfg: SlamConfig):
    """Births from the previous step's measurements, optionally gated to
    measurements not explained by an existing feature (addBirths,
    .bak:737-856; gating main.cpp:997-999). Also sets the binomial birth
    cardinality."""
    from math import lgamma

    n_births = 0
    for zi in z_prev:
        ok = True
        if cfg.gateBirths and len(p.w):
            d = p.mean - p.pose[:2]
            r = np.linalg.norm(d, axis=1)
            b = wrap(np.arctan2(d[:, 1], d[:, 0]) - p.pose[2])
            d2 = ((zi[0] - r) / cfg.stdRange) ** 2 \
                + (wrap(zi[1] - b) / cfg.stdBearing) ** 2
            ok = not np.any(d2 < cfg.gateThreshold ** 2)
        if ok:
            mean_b, cov_b = _birth(p.pose, zi, cfg)
            p.w = np.concatenate([p.w, [cfg.birthWeight]])
            p.mean = np.concatenate([p.mean, mean_b[None]])
            p.cov = np.concatenate([p.cov, cov_b[None]])
            n_births += 1

    ncard = cfg.maxCardinality + 1
    k = np.arange(ncard)
    cb = np.full(ncard, -np.inf)
    valid = k <= n_births
    lp, l1p = np.log(cfg.birthWeight), np.log1p(-cfg.birthWeight)
    for ki in k[valid]:
        cb[ki] = (lgamma(n_births + 1) - lgamma(ki + 1)
                  - lgamma(n_births - ki + 1) + ki * lp
                  + (n_births - ki) * l1p)
    p.cn_birth = cb


def _cphd_cn_predict(p: CpuParticle, cfg: SlamConfig):
    """cn_pred[n] = lse_{j<=n}(cn_birth[n-j] + cn[j])
    (cardinalityPredictKernel, .bak:512-545)."""
    if p.cn_birth is None:
        return
    ncard = cfg.maxCardinality + 1
    out = np.full(ncard, -np.inf)
    for n in range(ncard):
        out[n] = _logsumexp(p.cn_birth[n::-1] + p.cn[: n + 1])
    p.cn = out - _logsumexp(out)


def _cphd_psi(lam_log, qdw_ip, wsum_log, cn_predict, m_count, cfg):
    """Vo's Psi0/Psi1/Psi1d inner products in float64 log domain
    (computePsiKernel, .bak:1286-1430). lam_log [M]: log Lambda_m
    (unnormalized by <1,w>; the j-dependent normalization is applied
    here). Returns (psi0 [N+1], ip0, ip1, ip1d [M])."""
    from math import lgamma

    ncard = cn_predict.shape[0]
    # log ESF build-up (computeEsfKernel, .bak:1233-1247) + per-deleted
    esf = np.full(m_count + 1, -np.inf)
    esf[0] = 0.0
    for ll in lam_log:
        esf[1:] = np.logaddexp(esf[1:], ll + esf[:-1])
    esfd = np.full((m_count, max(m_count, 1)), -np.inf)
    for mi in range(m_count):
        e = np.full(m_count, -np.inf)
        e[0] = 0.0
        for mj in range(m_count):
            if mj == mi:
                continue
            e[1:] = np.logaddexp(e[1:], lam_log[mj] + e[:-1])
        esfd[mi] = e

    log_ratio = qdw_ip - wsum_log
    lfact = np.array([lgamma(j + 1) for j in range(ncard + 1)])
    lam_c = cfg.clutterRate
    cn_clut = np.array([j * np.log(lam_c) - lam_c - lfact[j]
                        for j in range(m_count + 1)])

    def perm(n, a):                      # log n!/(n-a)!
        return lfact[n] - lfact[n - a]

    ns = np.arange(ncard)
    psi0 = np.full(ncard, -np.inf)
    psi1 = np.full(ncard, -np.inf)
    for n in ns:
        t0, t1 = [], []
        for j in range(min(n, m_count) + 1):
            aux = (lfact[m_count - j] + cn_clut[m_count - j]
                   + esf[j] - j * wsum_log)
            t0.append(aux + perm(n, j) + (n - j) * log_ratio)
            if j + 1 <= n:
                t1.append(aux + perm(n, j + 1)
                          + (n - j - 1) * log_ratio - wsum_log)
        psi0[n] = _logsumexp(np.asarray(t0)) if t0 else -np.inf
        psi1[n] = _logsumexp(np.asarray(t1)) if t1 else -np.inf
    ip0 = _logsumexp(psi0 + cn_predict)
    ip1 = _logsumexp(psi1 + cn_predict)

    ip1d = np.full(m_count, -np.inf)
    for mi in range(m_count):
        terms = []
        for n in ns:
            for j in range(min(n, m_count - 1) + 1):
                if j + 1 > n:
                    continue
                terms.append(
                    lfact[m_count - 1 - j] + cn_clut[m_count - 1 - j]
                    + esfd[mi, j] - j * wsum_log + perm(n, j + 1)
                    + (n - j - 1) * log_ratio - wsum_log
                    + cn_predict[n])
        ip1d[mi] = _logsumexp(np.asarray(terms)) if terms else -np.inf
    return psi0, ip0, ip1, ip1d


def cphd_update(slam: CpuSlam, z: np.ndarray, cfg: SlamConfig):
    """CPHD measurement update (cphdPreUpdateKernel + computeEsfKernel +
    computePsiKernel + cphdUpdateKernel, .bak:1058-1478). Mutates
    particles; the particle weight increment is <Psi0, cn>
    (.bak:2663-2668)."""
    m_count = z.shape[0]
    if m_count == 0:
        return
    var_r, var_b = cfg.stdRange ** 2, cfg.stdBearing ** 2
    kappa = cfg.clutterDensity

    for p in slam.particles:
        pose = p.pose
        n_f = len(p.w)
        wsum = p.w.sum()
        if n_f == 0 or wsum <= 0:
            # no features: pure clutter likelihood; cardinality unchanged
            continue

        d = p.mean - pose[:2]
        r = np.linalg.norm(d, axis=1)
        bearing = wrap(np.arctan2(d[:, 1], d[:, 0]) - pose[2])
        in_m = (r >= cfg.minRange) & (r <= cfg.maxRange) \
            & (np.abs(bearing) <= cfg.maxBearing)
        # the CPHD kernels run on the in-range submap only (rclass != 0:
        # in-range + nearly-in-range, .bak:2199-2273); out-of-range
        # features are recombined untouched afterwards (.bak:2546-2580)
        set_m = in_m | ((r >= 0.8 * cfg.minRange)
                        & (r <= 1.2 * cfg.maxRange)
                        & (np.abs(bearing) <= 1.2 * cfg.maxBearing))
        pd = np.where(in_m, cfg.pd, 0.0)

        # Kalman pre-update terms for in-FOV features
        lw = np.full((m_count, n_f), -np.inf)
        mu_up = np.broadcast_to(p.mean[None], (m_count, n_f, 2)).copy()
        P_up = p.cov.copy()
        if in_m.any():
            ii = np.where(in_m)[0]
            di, ri, bi = d[ii], r[ii], bearing[ii]
            J = np.stack([
                np.stack([di[:, 0] / ri, di[:, 1] / ri], -1),
                np.stack([-di[:, 1] / ri ** 2, di[:, 0] / ri ** 2], -1)],
                -2)
            Pi = p.cov[ii]
            S = np.einsum("fij,fjk,flk->fil", J, Pi, J)
            S[:, 0, 0] += var_r
            S[:, 1, 1] += var_b
            off = 0.5 * (S[:, 0, 1] + S[:, 1, 0])
            S[:, 0, 1] = S[:, 1, 0] = off
            det_s = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
            s_inv = np.stack([
                np.stack([S[:, 1, 1], -S[:, 0, 1]], -1),
                np.stack([-S[:, 1, 0], S[:, 0, 0]], -1)], -2) \
                / det_s[:, None, None]
            K = np.einsum("fij,fkj,fkl->fil", Pi, J, s_inv)
            IKJ = np.eye(2) - np.einsum("fij,fjk->fik", K, J)
            R = np.diag([var_r, var_b])
            P_upd = np.einsum("fij,fjk,flk->fil", IKJ, Pi, IKJ) \
                + np.einsum("fij,jk,flk->fil", K, R, K)
            P_up[ii] = P_upd
            for mi in range(m_count):
                innov = np.stack([z[mi, 0] - ri,
                                  wrap(z[mi, 1] - bi)], -1)
                dist = np.einsum("fi,fij,fj->f", innov, s_inv, innov)
                lw[mi, ii] = (np.log(cfg.pd) + np.log(p.w[ii].clip(1e-300))
                              - 0.5 * dist - np.log(2 * np.pi)
                              - 0.5 * np.log(det_s))
                mu_up[mi, ii] = p.mean[ii] \
                    + np.einsum("fij,fj->fi", K, innov)

        # Psi machinery: Lambda_m = lam_c/kappa * <pd w N(z)> (log,
        # unnormalized; psi applies the <1,w>^-j factor). The <q_D,w>
        # and <1,w> inner products are over the in-range SUBMAP, the set
        # every CPHD kernel receives (computePsiKernel gets
        # dev_maps_inrange, .bak:2536-2541).
        wsum_set = p.w[set_m].sum()
        if wsum_set <= 0:
            # empty submap: nothing detectable — no update evidence; the
            # reference's kernels process a 0-length map (out-of-range
            # features recombine untouched, cardinality prior kept)
            if cfg.cnPoissonPredict:
                n_idx = np.arange(len(p.cn))
                cn_p = n_idx * np.log(max(wsum, 1e-300)) - wsum \
                    - np.array([lgamma(n + 1.0) for n in n_idx])
                p.cn = cn_p - _logsumexp(cn_p)
            continue
        lam_log = _logsumexp(lw, axis=1) + np.log(cfg.clutterRate) \
            - np.log(kappa)
        qdw_ip = _logsumexp(
            np.log(((1 - pd[set_m]) * p.w[set_m]).clip(1e-300)))
        if cfg.cnPoissonPredict:
            # Poisson prior of the IN-RANGE submap mass, rebuilt every
            # step (submap-consistent with the Psi evidence; see
            # cphd.cphd_update for why the full-map mass diverges)
            n_idx = np.arange(len(p.cn))
            cn_p = n_idx * np.log(max(wsum_set, 1e-300)) - wsum_set \
                - np.array([lgamma(n + 1.0) for n in n_idx])
            cn_prior = cn_p - _logsumexp(cn_p)
        else:
            cn_prior = p.cn
        psi0, ip0, ip1, ip1d = _cphd_psi(
            lam_log, qdw_ip, np.log(wsum_set), cn_prior, m_count, cfg)

        # weight updates (cphdUpdateKernel; per-feature pd in the
        # non-detection scale — deliberate fix of .bak:1469-1471).
        # In-range-set features get the (1-pd) * Psi-ratio scale;
        # out-of-range features pass through verbatim (.bak:2546-2580)
        w_nd = np.where(set_m, (1 - pd) * p.w * np.exp(ip1 - ip0), p.w)
        comps_w = [w_nd]
        comps_mu = [p.mean]
        comps_P = [p.cov]
        for mi in range(m_count):
            scale = ip1d[mi] - ip0 + np.log(cfg.clutterRate) \
                - np.log(kappa)
            comps_w.append(np.exp(lw[mi] + scale))
            comps_mu.append(mu_up[mi])
            comps_P.append(np.broadcast_to(P_up, (n_f, 2, 2)))
        uw = np.concatenate(comps_w)
        umu = np.concatenate(comps_mu)
        uP = np.concatenate(comps_P)

        # particle weight increment = <Psi0, cn> (.bak:2663-2668)
        p.log_weight += float(ip0)

        # cardinality posterior (from the step's prior — Poisson-rebuilt
        # under cnPoissonPredict, carried otherwise)
        cn_up = cn_prior + psi0 - ip0
        p.cn = cn_up - _logsumexp(cn_up)

        # prune + merge (whole map: the CPHD path has no in/near/out
        # sectioning, .bak:1058-1184 passes the full map through)
        keep = uw >= cfg.minFeatureWeight
        p.w, p.mean, p.cov = _greedy_merge(uw[keep], umu[keep], uP[keep],
                                           cfg)

    lws = np.array([q.log_weight for q in slam.particles])
    mx = lws.max()
    total = mx + np.log(np.exp(lws - mx).sum())
    for q in slam.particles:
        q.log_weight -= total


def neff(slam: CpuSlam):
    lws = np.array([p.log_weight for p in slam.particles])
    return 1.0 / np.sum(np.exp(2 * lws)) / len(lws)


def resample(slam: CpuSlam, rng, n_out: Optional[int] = None):
    n = len(slam.particles)
    n_out = n_out or n
    w = np.exp([p.log_weight for p in slam.particles])
    csum = np.cumsum(w)
    u = rng.uniform(size=n_out)
    rpos = (np.arange(n_out) + u) / n_out
    idx = np.searchsorted(csum, rpos)
    idx = np.minimum(idx, n - 1)
    new_parts = []
    for i in idx:
        src = slam.particles[i]
        new_parts.append(CpuParticle(
            src.pose.copy(), -np.log(n_out),
            src.w.copy(), src.mean.copy(), src.cov.copy(),
            cn=None if src.cn is None else src.cn.copy(),
            cn_birth=None if src.cn_birth is None
            else src.cn_birth.copy(),
            wd=None if src.wd is None else src.wd.copy(),
            mean4=None if src.mean4 is None else src.mean4.copy(),
            cov4=None if src.cov4 is None else src.cov4.copy()))
    slam.particles = new_parts
    slam.resample_idx = idx


def expected_pose(slam: CpuSlam):
    w = np.exp([p.log_weight for p in slam.particles])
    poses = np.stack([p.pose for p in slam.particles])
    return (w[:, None] * poses).sum(0)


def map_estimate(slam: CpuSlam):
    i = int(np.argmax([p.log_weight for p in slam.particles]))
    p = slam.particles[i]
    return p.w, p.mean, p.cov


def run(cfg: SlamConfig, controls, measurement_sets, seed=0,
        callback=None, label_sets=None):
    """Run the full CPU filter. controls [T-1, 2]; measurement_sets: list of
    [K,2] arrays; label_sets: optional list of [K] int label arrays
    (labeled mixed-model runs). Returns stacked expected poses [T, 6]."""
    rng = np.random.default_rng(seed)
    slam = CpuSlam.create(cfg)
    is_cphd = cfg.filterType == 1
    is_mixed = cfg.featureModel in (1, 2)
    out = []
    z_prev = np.zeros((0, 2))
    for t, z in enumerate(measurement_sets):
        if t > 0:
            u = controls[t - 1]
            for _ in range(max(cfg.subdividePredict, 1)):
                predict(slam, u, cfg, cfg.dt / max(cfg.subdividePredict, 1),
                        rng)
            if is_cphd:
                for p in slam.particles:
                    _cphd_cn_predict(p, cfg)
        if is_cphd and len(z_prev):
            # CPHD births come from the previous step's measurements
            # (addBirths(particles, ZPrev), .bak:68)
            for p in slam.particles:
                _cphd_add_births(p, np.asarray(z_prev), cfg)
        if len(z):
            if is_cphd:
                cphd_update(slam, np.asarray(z), cfg)
            elif is_mixed:
                lbl = np.asarray(label_sets[t], int) \
                    if label_sets is not None else None
                update_mixed(slam, np.asarray(z), cfg, z_label=lbl)
            else:
                update(slam, np.asarray(z), cfg)
        z_prev = z
        out.append(expected_pose(slam))
        if neff(slam) <= cfg.resampleThresh and len(z):
            resample(slam, rng, cfg.n_particles)
        if callback:
            callback(t, slam)
    return np.asarray(out)

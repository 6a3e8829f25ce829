"""Joint Compatibility Branch and Bound (JCBB) data association.

The port's copy of ``phdslam_tpu/ops/jcbb.py`` (NumPy, host-only; the two
are held equal by ``tests/test_torch_host.py``).

The working realization of the reference's EMPTY jcbb_kernel stub
(src/fastslam.cu:412-415; its intended inputs — the interpretation-tree
level, the pairwise Mahalanobis matrix Q from preupdate_kernel, and a
joint-compatibility flag array — are visible in the dead signature).

JCBB (Neira & Tardos 2001) associates a batch of measurements to map
features by searching the interpretation tree for the hypothesis with the
most pairings whose JOINT Mahalanobis distance passes a chi-square gate.
Its power over per-measurement (individual) gating comes from pose
uncertainty: a pose error shifts ALL predicted measurements coherently, so
innovations are correlated through the pose covariance, and a set of
pairings that are each individually compatible can be jointly impossible
(and vice versa).

Placement in this rebuild: inside FastSLAM the pose is a SAMPLED particle
(known), innovations are conditionally independent, and joint
compatibility degenerates to individual gating + mutual exclusion — which
filter/fastslam.py solves exactly with a vmapped auction on device. JCBB
therefore runs where it actually adds information: host-side association
against an uncertain pose estimate (e.g. the EAP pose + particle-cloud
covariance), which is inherently sequential branch-and-bound — host logic
by nature, like the reference intended (the stub is a __host__ function).

Range-bearing model, matching models/measurement.py:
    h(x, f) = [ ||f - p||, wrap(atan2(fy - py, fx - px) - yaw) ]
    Hp = dh/d(px, py, yaw)   [2, 3]      Hf = dh/d(fx, fy)   [2, 2]
    S[i, j] = Hp_i P Hp_j^T + delta_ij (Hf_i C_i Hf_i^T + R)
"""

from __future__ import annotations

import numpy as np

#: chi-square inverse CDF at 0.99 for 2k dof, k = 1..32 (precomputed so the
#: hot recursion never calls scipy; scipy.stats.chi2.ppf(0.99, 2k))
_CHI2_99 = np.array([
    9.21034, 13.2767, 16.8119, 20.0902, 23.2093, 26.2170, 29.1412,
    31.9999, 34.8053, 37.5662, 40.2894, 42.9798, 45.6417, 48.2782,
    50.8922, 53.4858, 56.0609, 58.6192, 61.1621, 63.6907, 66.2062,
    68.7095, 71.2014, 73.6826, 76.1539, 78.6156, 81.0688, 83.5135,
    85.9504, 88.3794, 90.8015, 93.2168])


def _chi2_gate(k: int) -> float:
    if k <= len(_CHI2_99):
        return float(_CHI2_99[k - 1])
    # Wilson-Hilferty approximation beyond the table
    d = 2.0 * k
    z = 2.3263478740408408  # Phi^-1(0.99)
    return float(d * (1.0 - 2.0 / (9.0 * d) + z * np.sqrt(2.0 / (9.0 * d)))
                 ** 3)


def predict_with_jacobians(pose, landmarks):
    """h(pose, f), Hp [F,2,3], Hf [F,2,2] for the range-bearing model."""
    pose = np.asarray(pose, np.float64)
    lm = np.atleast_2d(np.asarray(landmarks, np.float64))
    dx = lm[:, 0] - pose[0]
    dy = lm[:, 1] - pose[1]
    r2 = dx * dx + dy * dy
    r = np.sqrt(r2)
    b = np.arctan2(dy, dx) - pose[2]
    b = (b + np.pi) % (2.0 * np.pi) - np.pi
    zhat = np.stack([r, b], axis=1)
    hp = np.empty((lm.shape[0], 2, 3))
    hp[:, 0, 0] = -dx / r
    hp[:, 0, 1] = -dy / r
    hp[:, 0, 2] = 0.0
    hp[:, 1, 0] = dy / r2
    hp[:, 1, 1] = -dx / r2
    hp[:, 1, 2] = -1.0
    hf = np.empty((lm.shape[0], 2, 2))
    hf[:, 0, 0] = dx / r
    hf[:, 0, 1] = dy / r
    hf[:, 1, 0] = -dy / r2
    hf[:, 1, 1] = dx / r2
    return zhat, hp, hf


def jcbb(z, landmarks, landmark_covs, pose, pose_cov, std_range,
         std_bearing, confidence_gate: float = 9.21):
    """JCBB association of measurements to landmarks.

    z [M, 2] (range, bearing); landmarks [F, 2]; landmark_covs [F, 2, 2];
    pose (x, y, yaw); pose_cov [3, 3]; R = diag(std_range^2,
    std_bearing^2). confidence_gate: individual chi-square(2) gate used to
    enumerate per-measurement candidates (the joint gate is chi2(0.99, 2k)
    at each tree level).

    Returns assoc [M] int array: landmark index or -1 (spurious/new).
    Maximizes pairing count; ties break to the smallest joint Mahalanobis
    distance, the standard JCBB objective.
    """
    z = np.atleast_2d(np.asarray(z, np.float64))
    lm = np.atleast_2d(np.asarray(landmarks, np.float64))
    m, f = z.shape[0], lm.shape[0]
    if m == 0 or f == 0:
        return np.full((m,), -1, np.int64)
    pc = np.asarray(pose_cov, np.float64)
    r_mat = np.diag([std_range ** 2, std_bearing ** 2])
    lc = np.asarray(landmark_covs, np.float64).reshape(f, 2, 2)

    zhat, hp, hf = predict_with_jacobians(pose, lm)
    innov = z[:, None, :] - zhat[None, :, :]                  # [M, F, 2]
    innov[..., 1] = (innov[..., 1] + np.pi) % (2.0 * np.pi) - np.pi

    # pose-correlation blocks G[i, j] = Hp_i P Hp_j^T, [F, F, 2, 2], plus
    # the independent per-landmark term on the diagonal
    hp_p = hp @ pc                                            # [F, 2, 3]
    g = np.einsum("iab,jcb->ijac", hp_p, hp)                  # [F, F, 2, 2]
    own = np.einsum("iab,ibc,idc->iad", hf, lc, hf) + r_mat   # [F, 2, 2]

    # individual compatibility: D2_ind[m, f] with the FULL per-pair
    # innovation covariance S_ff = G[f, f] + own[f]
    s_ind = g[np.arange(f), np.arange(f)] + own               # [F, 2, 2]
    s_inv = np.linalg.inv(s_ind)
    d2_ind = np.einsum("mfa,fab,mfb->mf", innov, s_inv, innov)
    compatible = d2_ind <= confidence_gate

    best = {"count": 0, "d2": np.inf,
            "assoc": np.full((m,), -1, np.int64)}

    def joint_d2(pairs):
        """Joint Mahalanobis distance of hypothesis pairs [(mi, fi), ...]."""
        k = len(pairs)
        nu = np.concatenate([innov[mi, fi] for mi, fi in pairs])
        s = np.empty((2 * k, 2 * k))
        for a, (_, fa) in enumerate(pairs):
            for b, (_, fb) in enumerate(pairs):
                blk = g[fa, fb].copy()
                if a == b:
                    blk += own[fa]
                s[2 * a:2 * a + 2, 2 * b:2 * b + 2] = blk
        try:
            sol = np.linalg.solve(s, nu)
        except np.linalg.LinAlgError:
            return np.inf
        return float(nu @ sol)

    def recurse(i, pairs, used):
        count = len(pairs)
        # bound: even pairing every remaining measurement can't beat best
        if count + (m - i) < best["count"]:
            return
        if i == m:
            d2 = joint_d2(pairs) if pairs else 0.0
            if count > best["count"] or (count == best["count"]
                                         and d2 < best["d2"]):
                assoc = np.full((m,), -1, np.int64)
                for mi, fi in pairs:
                    assoc[mi] = fi
                best.update(count=count, d2=d2, assoc=assoc)
            return
        # try candidate landmarks in order of individual distance
        cands = np.where(compatible[i] & ~used)[0]
        cands = cands[np.argsort(d2_ind[i, cands])]
        for fi in cands:
            trial = pairs + [(i, int(fi))]
            d2 = joint_d2(trial)
            if d2 <= _chi2_gate(len(trial)):
                used[fi] = True
                recurse(i + 1, trial, used)
                used[fi] = False
        # null branch (measurement i unpaired)
        recurse(i + 1, pairs, used)

    recurse(0, [], np.zeros((f,), bool))
    return best["assoc"]


def nn_associate(z, landmarks, landmark_covs, pose, pose_cov, std_range,
                 std_bearing, gate: float = 9.21):
    """Individual-compatibility nearest-neighbour association (the baseline
    JCBB improves on): per measurement, the gated argmin of the individual
    Mahalanobis distance, with first-come mutual exclusion."""
    z = np.atleast_2d(np.asarray(z, np.float64))
    lm = np.atleast_2d(np.asarray(landmarks, np.float64))
    m, f = z.shape[0], lm.shape[0]
    if m == 0 or f == 0:
        return np.full((m,), -1, np.int64)
    pc = np.asarray(pose_cov, np.float64)
    r_mat = np.diag([std_range ** 2, std_bearing ** 2])
    lc = np.asarray(landmark_covs, np.float64).reshape(f, 2, 2)
    zhat, hp, hf = predict_with_jacobians(pose, lm)
    innov = z[:, None, :] - zhat[None, :, :]
    innov[..., 1] = (innov[..., 1] + np.pi) % (2.0 * np.pi) - np.pi
    s_ind = (np.einsum("iab,bc,idc->iad", hp, pc, hp)
             + np.einsum("iab,ibc,idc->iad", hf, lc, hf) + r_mat)
    d2 = np.einsum("mfa,fab,mfb->mf", innov, np.linalg.inv(s_ind), innov)
    assoc = np.full((m,), -1, np.int64)
    used = np.zeros((f,), bool)
    for i in range(m):
        order = np.argsort(d2[i])
        for fi in order:
            if d2[i, fi] > gate:
                break
            if not used[fi]:
                assoc[i] = fi
                used[fi] = True
                break
    return assoc

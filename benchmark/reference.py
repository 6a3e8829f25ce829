"""The plain reference of one static GM-PHD SLAM step, in PyTorch.

Written for the benchmark from the filter's equations (the CUDA
reference's semantics as the port's README and ``PERF.md`` state them),
in plain tensor operations with no kernel, and importing nothing of the
program. It computes what one ``slam_step`` of the static map computes
under the configurations of ``benchmark/configs``: filter_type 0,
feature_model 0, particle_weighting 0, Ackerman motion, exact greedy
merge (merge_mode 0) of the pool of the kept map, the top-k1 detection
terms of each measurement and one birth per measurement, births not
gated, the stratified resample when nEff falls to the threshold.

The step is split where the particles stop being independent:

- ``particle_stage``: prediction, the Kalman pre-update, the likelihoods
  with their normalisers and the top-k1 select, the births, the pool and
  the greedy merge, and each particle's weight increment. It runs in
  blocks of particles, so any particle count fits.
- ``global_stage``: the weight normalisation, nEff, the expected pose,
  the resample trigger and the cumulative weights the resample reads.

The precision ``q`` is applied to every stage's tensors: ``EXACT`` leaves
them in float32, as the configuration states; ``TF32`` rounds them to
TF32's 10-bit mantissa (the control that the comparison has to refuse).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

LOG_2PI = 1.8378770664093453
NEG_LARGE = -1e30
#: the supported semantics: cfg keys and the values the step assumes
REQUIRED = dict(filter_type=0, feature_model=0, particle_weighting=0,
                motion_type=1, merge_mode=0, gate_births=0,
                distance_metric=0, labeled_measurements=0,
                n_predict_particles=1, subdivide_predict=1,
                select_by_index=0, dynamic_measurement_count=1)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10 mantissa
    bits; other dtypes unchanged."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    bits = (bits + 0xFFF + keep) & ~0x1FFF
    out = bits.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def EXACT(x: torch.Tensor) -> torch.Tensor:
    return x


TF32 = round_tf32


def check_config(c: dict):
    """Raise unless the cfg dict c has the semantics this step computes."""
    for k, v in REQUIRED.items():
        if int(c[k]) != v:
            raise ValueError(f"the reference computes {k} = {v}, the "
                             f"configuration has {c[k]}")


def clutter_density(c: dict) -> float:
    return c["clutter_rate"] / (2.0 * c["max_bearing"] * c["max_range"])


def k1_of(c: dict) -> int:
    return min(int(c["select_top_k"]) or 8, int(c["max_features"]))


def block_for(c: dict, P: int, budget: int = 1 << 27) -> int:
    """Particles per block: [block, M, F] within budget elements."""
    per = int(c["max_measurements"]) * int(c["max_features"])
    return max(1, min(P, budget // per))


def wrap_angle(a):
    """Into [-pi, pi] by fmod, then one fold."""
    two_pi = 2.0 * math.pi
    r = torch.fmod(a, two_pi)
    r = torch.where(r > math.pi, r - two_pi, r)
    return torch.where(r < -math.pi, r + two_pi, r)


def wrap_round(x):
    """x - 2 pi round(x / 2 pi), the quotient in IEEE float32 (2 pi as a
    tensor: a division by a Python scalar multiplies by its reciprocal)."""
    two_pi = x.new_tensor(2.0 * math.pi)
    return x - two_pi * torch.round(x / two_pi)


def safe_log(x):
    return torch.where(x > 0, torch.log(torch.clamp(x, min=1e-38)),
                       torch.finfo(x.dtype).min)


class Map(NamedTuple):
    """Six [P, F] channels; an empty slot has w = 0."""

    w: torch.Tensor
    mx: torch.Tensor
    my: torch.Tensor
    c00: torch.Tensor
    c01: torch.Tensor
    c11: torch.Tensor


def initial_state(c: dict, n: int, device):
    """(pose [n, 6], log weights [n], Map): every particle at the start
    pose, uniform weights, an empty map."""
    f = int(c["max_features"])
    pose = torch.tensor([c["initial_x"], c["initial_y"], c["initial_yaw"],
                         0.0, 0.0, 0.0], dtype=torch.float32,
                        device=device).expand(n, 6).clone()
    lw = torch.full((n,), -math.log(float(n)), dtype=torch.float32,
                    device=device)
    z = lambda: torch.zeros((n, f), dtype=torch.float32, device=device)
    o = lambda: torch.ones((n, f), dtype=torch.float32, device=device)
    return pose, lw, Map(z(), z(), z(), o(), z(), o())


def predict(pose, control, normals, c, dt):
    """Ackerman motion of every particle with the scaled draws."""
    scale = torch.tensor([c["std_encoder"], c["std_alpha"]],
                         dtype=pose.dtype, device=pose.device)
    n = normals * scale
    theta = pose[:, 2]
    ve = control[0] + n[:, 0]
    al = control[1] + n[:, 1]
    l, h, a, b = c["l"], c["h"], c["a"], c["b"]
    vc = ve / (1.0 - torch.tan(al) * h / l)
    xd = vc * torch.cos(theta)
    yd = vc * torch.sin(theta)
    td = vc * torch.tan(al) / l
    px = pose[:, 0] + dt * (xd - td * (a * torch.sin(theta)
                                       + b * torch.cos(theta)))
    py = pose[:, 1] + dt * (yd + td * (a * torch.cos(theta)
                                       - b * torch.sin(theta)))
    pth = wrap_angle(theta + dt * td)
    zero = torch.zeros_like(px)
    return torch.stack([px, py, pth, zero, zero, zero], dim=-1)


def preupdate(pose, m: Map, c):
    """The EKF terms of every (particle, slot): in-range mask, pd, range
    and bearing, S^-1, log det S, the gain and the Joseph-form covariance
    (the cancellation-free det S of the program's semantics)."""
    dx = m.mx - pose[:, None, 0]
    dy = m.my - pose[:, None, 1]
    r = torch.sqrt(dx * dx + dy * dy)
    bear = wrap_angle(torch.atan2(dy, dx) - pose[:, None, 2])
    inside = ((r >= c["min_range"]) & (r <= c["max_range"])
              & (bear.abs() <= c["max_bearing"]) & (m.w > 0))
    pd = torch.where(inside, c["pd"], 0.0).to(m.w.dtype)
    dx = torch.where(inside, dx, 1.0)
    dy = torch.where(inside, dy, 0.0)
    r2s = dx * dx + dy * dy
    rs = torch.sqrt(r2s)
    j00, j01, j10, j11 = dx / rs, dy / rs, -dy / r2s, dx / r2s
    p00, p01, p11 = m.c00, m.c01, m.c11
    var_r, var_b = c["std_range"] ** 2, c["std_bearing"] ** 2
    a00 = j00 * (j00 * p00 + j01 * p01) + j01 * (j00 * p01 + j01 * p11)
    a01 = j10 * (j00 * p00 + j01 * p01) + j11 * (j00 * p01 + j01 * p11)
    a11 = j10 * (j10 * p00 + j11 * p01) + j11 * (j10 * p01 + j11 * p11)
    s00, s01, s11 = a00 + var_r, a01, a11 + var_b
    det_p = torch.clamp(p00 * p11 - p01 * p01, min=0.0)
    det_s = det_p / r2s + a00 * var_b + a11 * var_r + var_r * var_b
    det_s = torch.clamp(det_s, min=var_r * var_b)
    si00, si01, si11 = s11 / det_s, -s01 / det_s, s00 / det_s
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
    return dict(inside=inside, pd=pd, r=r, b=bear, si00=si00, si01=si01,
                si11=si11, lds=torch.log(det_s), g00=g00, g01=g01, g10=g10,
                g11=g11, u00=u00, u01=u01, u11=u11)


def select(pre, m: Map, zr, zb, n_valid: int, c, q):
    """Per measurement: the sum of its detection terms over the slots and
    its k1 largest normalised terms (largest first, lowest slot on ties;
    terms under the minimum weight dropped), with their updated means and
    covariances. Columns at or past n_valid are zero."""
    k1 = k1_of(c)
    lpw = torch.clamp(safe_log(pre["pd"]) + safe_log(m.w), min=NEG_LARGE)
    base = lpw - LOG_2PI - 0.5 * pre["lds"]
    ir = zr[None, :, None] - pre["r"][:, None, :]              # [P, M, F]
    ib = wrap_round(zb[None, :, None] - pre["b"][:, None, :])
    d2 = (ir * ir * pre["si00"][:, None, :]
          + 2.0 * ir * ib * pre["si01"][:, None, :]
          + ib * ib * pre["si11"][:, None, :])
    d2 = torch.clamp(d2, min=0.0)
    e = q(torch.exp(base[:, None, :] - 0.5 * d2))
    del ir, ib, d2
    s = q(e.sum(-1))                                           # [P, M]
    cb = clutter_density(c) + c["birth_weight"]
    wrem = e * (1.0 / (s + cb))[..., None]
    wrem = torch.where(wrem >= c["min_feature_weight"], wrem, 0.0)
    del e
    vals, idxs = [], []
    for _ in range(k1):
        first = torch.argmax(wrem, dim=-1, keepdim=True)
        vals.append(torch.gather(wrem, -1, first))
        idxs.append(first)
        wrem = wrem.scatter(-1, first, 0.0)
    w_sel = torch.cat(vals, -1)
    f_sel = torch.cat(idxs, -1)
    w_sel = torch.where(w_sel > 0.0, w_sel, 0.0)
    P, F = pre["r"].shape
    M = zr.shape[0]
    take = lambda a: torch.gather(a[:, None, :].expand(P, M, F), 2, f_sel)
    ir_s = zr[None, :, None] - take(pre["r"])
    ib_s = wrap_round(zb[None, :, None] - take(pre["b"]))
    sel = [w_sel,
           take(m.mx) + take(pre["g00"]) * ir_s + take(pre["g01"]) * ib_s,
           take(m.my) + take(pre["g10"]) * ir_s + take(pre["g11"]) * ib_s,
           take(pre["u00"]), take(pre["u01"]), take(pre["u11"])]
    live = (torch.arange(M, device=zr.device) < n_valid)[None, :]
    s = torch.where(live, s, 0.0)
    sel = [q(torch.where(live[..., None], a, 0.0)) for a in sel]
    return s, sel


def merge(w, mx, my, c00, c01, c11, min_sep: float, cap: int, q):
    """Greedy merge of the [P, K] pool into [P, cap] slots: take the
    heaviest remaining candidate (the first of equal weights), merge it
    with every remaining candidate whose squared Mahalanobis distance
    under the pair's averaged covariance is below min_sep, moment-match
    about the pick; stop when nothing is left."""
    P, K = w.shape
    out_w = w.new_zeros((P, cap))
    out_mx, out_my, out_01 = (w.new_zeros((P, cap)) for _ in range(3))
    out_00, out_11 = w.new_ones((P, cap)), w.new_ones((P, cap))
    w_rem = w.clone()
    col = torch.arange(K, device=w.device)
    for i in range(cap):
        pick = torch.argmax(w_rem, dim=1, keepdim=True)
        mval = torch.gather(w_rem, 1, pick)
        if not bool((mval > 0.0).any()):
            break
        take = lambda a: torch.gather(a, 1, pick)
        rmx, rmy = take(mx), take(my)
        r00, r01, r11 = take(c00), take(c01), take(c11)
        dx = rmx - mx
        dy = rmy - my
        a00 = 0.5 * (r00 + c00)
        a01 = 0.5 * (r01 + c01)
        a11 = 0.5 * (r11 + c11)
        det = a00 * a11 - a01 * a01
        quad = dx * dx * a11 - 2.0 * (dx * dy) * a01 + dy * dy * a00
        near = quad < min_sep * det
        sel = ((near & (w_rem > 0.0)) | (col[None, :] == pick)) \
            & (mval > 0.0)
        sw = torch.where(sel, w_rem, 0.0)
        wsum = sw.sum(1)
        live = wsum > 0.0
        inv = torch.where(live, 1.0 / torch.clamp(wsum, min=1e-38), 0.0)
        mcx = (sw * dx).sum(1) * inv
        mcy = (sw * dy).sum(1) * inv
        n00 = (sw * (c00 + dx * dx)).sum(1) * inv - mcx * mcx
        n01 = (sw * (c01 + dx * dy)).sum(1) * inv - mcx * mcy
        n11 = (sw * (c11 + dy * dy)).sum(1) * inv - mcy * mcy
        out_w[:, i] = wsum
        out_mx[:, i] = torch.where(live, rmx[:, 0] - mcx, 0.0)
        out_my[:, i] = torch.where(live, rmy[:, 0] - mcy, 0.0)
        out_00[:, i] = torch.where(live, n00, 1.0)
        out_01[:, i] = n01
        out_11[:, i] = torch.where(live, n11, 1.0)
        w_rem = torch.where(sel, 0.0, w_rem)
    return Map(*(q(t) for t in (out_w, out_mx, out_my, out_00, out_01,
                                out_11)))


def update(pose, m: Map, zr, zb, count: int, c, q):
    """The measurement update of a block of particles: (new Map, the
    weight increment [P]). zr, zb [M]; the first ``count`` are valid."""
    P, F = m.w.shape
    M = zr.shape[0]
    pre = {k: q(v) if v.dtype == torch.float32 else v
           for k, v in preupdate(pose, m, c).items()}
    valid = (torch.arange(M, device=zr.device) < count)[None, :]
    s, (w_sel, mx_sel, my_sel, u00, u01, u11) = select(
        pre, m, zr, zb, count, c, q)
    s = torch.where(valid, s, 0.0)
    w_sel = torch.where(valid[..., None], w_sel, 0.0)
    bw = c["birth_weight"]
    normalizer = s + clutter_density(c) + bw
    log_norm = safe_log(normalizer)
    inside = pre["inside"]
    w_nd = torch.where(inside, m.w * (1.0 - pre["pd"]), 0.0)
    w_birth = torch.where(valid, bw / normalizer, 0.0)
    mvalid = valid.to(m.w.dtype)
    n_measure = mvalid.sum(-1)
    card_pred = (pre["pd"] * m.w).sum(-1) + n_measure * bw
    dw = (log_norm * mvalid).sum(-1) - card_pred
    minw = c["min_feature_weight"]
    w_nd = torch.where(w_nd >= minw, w_nd, 0.0)
    w_birth = torch.where(w_birth >= minw, w_birth, 0.0)
    w_keep = torch.where(inside, w_nd, m.w)
    w_sel = torch.where(w_sel >= minw, w_sel, 0.0)
    theta = pose[:, None, 2] + zb[None, :]
    ct, st = torch.cos(theta), torch.sin(theta)
    bdx = zr[None, :] * ct
    bdy = zr[None, :] * st
    var_rb = (c["std_range"] * c["birth_noise_factor"]) ** 2
    var_bb = (c["std_bearing"] * c["birth_noise_factor"]) ** 2
    flat = lambda a: a.reshape(P, -1)
    cat = lambda a, b, d: q(torch.cat([a, flat(b), d], dim=-1))
    new = merge(
        cat(w_keep, w_sel, w_birth),
        cat(m.mx, mx_sel, pose[:, None, 0] + bdx),
        cat(m.my, my_sel, pose[:, None, 1] + bdy),
        cat(m.c00, u00, ct * ct * var_rb + bdy * bdy * var_bb),
        cat(m.c01, u01, ct * st * var_rb - bdy * bdx * var_bb),
        cat(m.c11, u11, st * st * var_rb + bdx * bdx * var_bb),
        c["min_separation"], F, q)
    return new, q(dw)


class Particles(NamedTuple):
    """The post-update, pre-resample particles and their unnormalised
    log weights."""

    pose: torch.Tensor
    lw: torch.Tensor
    map: Map


def particle_stage(pose, lw, m: Map, control, zr, zb, count: int,
                   do_predict: bool, normals, c, dt: float,
                   q=EXACT, block: int = 8192):
    """Every particle's prediction and update, in blocks of ``block``
    particles. pose [P, 6], lw [P], m: Map [P, F]; normals [P, 2];
    zr, zb [M]. Returns Particles (lw = the input lw plus the increment)."""
    poses, lws, maps = [], [], []
    for lo in range(0, pose.shape[0], block):
        sl = slice(lo, lo + block)
        p = q(pose[sl])
        mb = Map(*(q(t[sl]) for t in m))
        if do_predict:
            p = q(predict(p, control, q(normals[sl]), c, dt))
        if count > 0:
            mb, dw = update(p, mb, zr, zb, count, c, q)
            lws.append(q(q(lw[sl]) + dw))
        else:
            lws.append(q(lw[sl]))
        poses.append(p)
        maps.append(mb)
    return Particles(torch.cat(poses), torch.cat(lws),
                     Map(*(torch.cat(ch) for ch in zip(*maps))))


class Global(NamedTuple):
    lw: torch.Tensor         # normalised log weights [P]
    neff: float
    expected_pose: torch.Tensor  # [6]
    fire: bool
    cum: torch.Tensor        # float64 cumulative weights [P]


def global_stage(lw_unnorm, pose, c, q=EXACT,
                 updated: bool = True) -> Global:
    """Normalisation (logsumexp), nEff = 1 / sum w^2 / P, the expected
    pose sum w pose, and the resample's trigger nEff <= threshold (only
    after an update); the cumulative weights in float64, for judging the
    resample."""
    P = lw_unnorm.shape[0]
    if updated:
        lw = q(lw_unnorm - torch.logsumexp(lw_unnorm, 0))
    else:
        lw = lw_unnorm
    neff = float(1.0 / torch.sum(torch.exp(2.0 * lw)) / P)
    exp_pose = q((torch.exp(lw)[:, None] * pose).sum(0))
    fire = updated and neff <= c["resample_threshold"]
    cum = torch.cumsum(torch.exp(lw.double()), 0)
    return Global(lw, neff, exp_pose, fire, cum)


def resample_indices(lw, u):
    """The stratified resample: slot j takes the particle whose
    cumulative weight first reaches (j + u_j) / P; past the end, the
    heaviest particle."""
    P = lw.shape[0]
    csum = torch.cumsum(torch.exp(lw), 0)
    r = (torch.arange(P, dtype=lw.dtype, device=lw.device) + u) / float(P)
    idx = torch.searchsorted(csum, r, side="left")
    return torch.where(idx >= P, torch.argmax(lw), idx)


def step(pose, lw, m: Map, control, zr, zb, count: int, do_predict: bool,
         normals, uniforms, c, dt: float, q=EXACT):
    """One whole step as a program would return it: (pose, lw, Map,
    resample indices, expected pose, nEff, fired) after the resample."""
    parts = particle_stage(pose, lw, m, control, zr, zb, count, do_predict,
                           normals, c, dt, q, block_for(c, pose.shape[0]))
    g = global_stage(parts.lw, parts.pose, c, q, count > 0)
    P = pose.shape[0]
    if g.fire:
        idx = resample_indices(g.lw, uniforms)
        new_lw = torch.full_like(g.lw, -math.log(float(P)))
    else:
        idx = torch.arange(P, device=pose.device)
        new_lw = g.lw
    return (parts.pose[idx], new_lw, Map(*(t[idx] for t in parts.map)),
            idx, g.expected_pose, g.neff, g.fire)

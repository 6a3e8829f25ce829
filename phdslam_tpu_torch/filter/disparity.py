"""Monocular SC-PHD SLAM in disparity space (run type ``disparity``), a port
of ``phdslam_tpu/filter/disparity.py``.

Each particle carries a 6-DOF camera state and a PHD map whose features are
clouds of ``particlesPerFeature`` 3-D world points plus a mixture weight.
One step:

  1. 6-DOF constant-velocity camera prediction
  2. world -> disparity (u, v, d) of every cloud point
  3. a 3-D Gaussian fitted to each feature's disparity cloud
  4. in-image gating on the fitted mean
  5. EKF pre-update in disparity space (H = [I2 | 0] picks u, v)
  6. the PHD update: per-measurement normalisers and particle weights
  7. pool [non-detections F | top-k1 detections per measurement M k1 |
     births M] and the 3-D greedy merge (``kernels/merge3.py``)
  8. the merged Gaussians sampled back to clouds and mapped to the world;
     the out-of-view clouds pass through
  9. expected pose, then resampling when nEff falls below the threshold

The random draws come in through ``noise = (pose_normals [P, 6],
cloud_normals [P, F, Npp, 3], resample_uniforms [P])`` (the JAX step's
three keys), or from a ``torch.Generator``. Whether to predict and whether
the step has measurements are host bools; the resample trigger stays on the
device (``torch.where``), so a step never reads the device.

With a ``mesh`` (``parallel/mesh.py``) the state holds the rank's P/W
rows: the update runs on them, and the logsumexp, the expected pose, nEff
and the resample read the gathered weights and poses (traffic label
"step"); every rank draws the global step's draws and uses its rows.
Unlike ``filter/step.py``'s sharded step, the resample's gather of the
pose, weights and clouds (label "resample") runs on every step, fired or
not, as JAX's ungated ``jnp.take`` does.

Top-k ties: ``ops/gm.py::top_k`` keeps ``jax.lax.top_k``'s order (the lower
index first among equal values), so empty slots (w = 0) carry the same
clouds as in JAX.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from phdslam_tpu_torch.filter.state import Measurements, _TensorTree
from phdslam_tpu_torch.models.camera import (camera_cv_predict,
                                             disparity_to_world,
                                             world_to_disparity)
from phdslam_tpu_torch.ops.gm import (fast_prune_renormalize,
                                      greedy_merge_channels3, top_k)
from phdslam_tpu_torch.ops.linalg import device_row, safe_log
from phdslam_tpu_torch.ops.resample import neff, stratified_resample_indices
from phdslam_tpu_torch.parallel.mesh import (everywhere, gather_rows,
                                             global_row)

LOG_2PI = 1.8378770664093453


@dataclass
class DisparityState(_TensorTree):
    """Per-particle camera and particle-cloud PHD map."""

    pose: torch.Tensor           # [P, 12] 6-DOF pose + velocities
    log_weights: torch.Tensor    # [P]
    w: torch.Tensor              # [P, F] feature weights (0 = empty)
    px: torch.Tensor             # [P, F, Npp] world-frame clouds
    py: torch.Tensor
    pz: torch.Tensor
    resample_idx: torch.Tensor   # [P] int32

    @property
    def n_particles(self) -> int:
        return self.pose.shape[0]

    @classmethod
    def create(cls, cfg, device=None, max_features: Optional[int] = None,
               dtype=torch.float32) -> "DisparityState":
        n = cfg.n_particles
        f = max_features or cfg.maxFeatures
        npp = cfg.particlesPerFeature
        pose0 = torch.tensor(
            [cfg.x0, cfg.y0, cfg.z0, cfg.roll0, cfg.pitch0, cfg.yaw0,
             cfg.vx0, cfg.vy0, cfg.vz0, cfg.vroll0, cfg.vpitch0,
             cfg.vyaw0], dtype=dtype, device=device)
        cloud = lambda: torch.zeros((n, f, npp), dtype=dtype, device=device)
        return cls(
            pose=pose0.expand(n, 12).clone(),
            log_weights=torch.full((n,), -math.log(float(n)), dtype=dtype,
                                   device=device),
            w=torch.zeros((n, f), dtype=dtype, device=device),
            px=cloud(), py=cloud(), pz=cloud(),
            resample_idx=torch.arange(n, dtype=torch.int32, device=device))


def fit_gaussians(u, v, d):
    """Sample mean and covariance (divided by n - 1) of each cloud. u, v, d
    [..., Npp]; returns 3 mean and 6 covariance channels [...]."""
    npp = u.shape[-1]
    mu_u, mu_v, mu_d = u.mean(-1), v.mean(-1), d.mean(-1)
    du = u - mu_u[..., None]
    dv = v - mu_v[..., None]
    dd = d - mu_d[..., None]
    den = 1.0 / (npp - 1)
    return (mu_u, mu_v, mu_d,
            (du * du).sum(-1) * den, (du * dv).sum(-1) * den,
            (du * dd).sum(-1) * den, (dv * dv).sum(-1) * den,
            (dv * dd).sum(-1) * den, (dd * dd).sum(-1) * den)


def sample_gaussians(x, m0, m1, m2, c00, c01, c02, c11, c12, c22):
    """Samples of each channelized 3-D Gaussian from the standard normals
    x [..., npp, 3], through the closed-form Cholesky factor. Returns
    (u, v, d), each [..., npp]."""
    eps = 1e-9
    l11 = torch.sqrt(torch.clamp(c00, min=eps))
    l21 = c01 / l11
    l22 = torch.sqrt(torch.clamp(c11 - l21 * l21, min=eps))
    l31 = c02 / l11
    l32 = (c12 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(c22 - l31 * l31 - l32 * l32, min=eps))
    u = m0[..., None] + x[..., 0] * l11[..., None]
    v = m1[..., None] + (x[..., 0] * l21[..., None]
                         + x[..., 1] * l22[..., None])
    d = m2[..., None] + (x[..., 0] * l31[..., None]
                         + x[..., 1] * l32[..., None]
                         + x[..., 2] * l33[..., None])
    return u, v, d


class DispAux(NamedTuple):
    expected_pose: torch.Tensor   # [12]
    neff: torch.Tensor            # scalar
    n_measure: torch.Tensor       # scalar


def draw_noise(state: DisparityState, generator=None, n_particles=None):
    """One step's draws: (pose_normals [P, 6], cloud_normals [P, F, Npp, 3],
    resample_uniforms [P]); P the state's particles unless given (a
    sharded step draws the global count)."""
    P, F, npp = state.px.shape
    P = P if n_particles is None else n_particles
    kw = dict(generator=generator, device=state.pose.device,
              dtype=state.pose.dtype)
    return (torch.randn((P, 6), **kw), torch.randn((P, F, npp, 3), **kw),
            torch.rand((P,), **kw))


def disparity_step(state: DisparityState, z: Measurements, dt: float,
                   do_predict: bool, cfg, *, generator=None, noise=None,
                   mesh=None):
    """One SC-PHD step; returns (state', DispAux). z holds the (u, v) image
    measurements in ``rb``; ``z.count`` (host int) gates the update. With
    a mesh the state holds the rank's rows, ``noise`` is the global
    step's and the aux values are global."""
    n_ranks = 1 if mesh is None else mesh.world_size
    P = state.px.shape[0] * n_ranks
    dev, dtype = state.w.device, state.w.dtype
    if noise is None:
        noise = draw_noise(state, generator, P)
    pose_normals, cloud_normals, uniforms = noise
    every, own = everywhere(mesh, "step")
    if mesh is not None:
        pose_normals, cloud_normals = own(pose_normals), own(cloud_normals)
    z_uv, z_valid = z.rb, z.valid
    clutter_density = cfg.clutterRate / (cfg.imageWidth * cfg.imageHeight)

    # ---- 1. camera prediction ----
    pose = state.pose
    if do_predict:
        acc = device_row((cfg.ax, cfg.ay, cfg.az, cfg.aroll, cfg.apitch,
                          cfg.ayaw), pose)
        pose = camera_cv_predict(pose, pose_normals * acc, cfg, dt)

    n_measure = z_valid.to(dtype).sum()
    has_z = z.count > 0
    new_w, new_px, new_py, new_pz = state.w, state.px, state.py, state.pz
    lw_new = state.log_weights
    if has_z:
        new_w, new_px, new_py, new_pz, dw = _update(
            state, pose, cloud_normals, z_uv, z_valid, n_measure,
            clutter_density, cfg)
        lw_new = every(state.log_weights + dw)
        lw_new = lw_new - torch.logsumexp(lw_new, 0)
    else:
        lw_new = every(lw_new)

    # ---- expected pose + resample (global) ----
    exp_pose = (torch.exp(lw_new)[:, None] * every(pose)).sum(0)
    n_eff = neff(lw_new)
    arange = torch.arange(P, dtype=torch.int32, device=dev)
    if has_z:
        trigger = n_eff <= cfg.resampleThresh
        idx = torch.where(trigger, stratified_resample_indices(
            lw_new, uniforms, P), arange)
        lw_final = torch.where(trigger, torch.full_like(lw_new,
                                                        -math.log(float(P))),
                               lw_new)
    else:
        idx, lw_final = arange, lw_new
    idx, lw_final = own(idx), own(lw_final)
    # every leaf gathered on every step, whether or not the resample fires:
    # JAX's ungated jnp.take (phdslam_tpu/filter/disparity.py), not
    # slam_step's lax.cond
    gather = everywhere(mesh, "resample")[0]
    take = lambda x: gather(x).index_select(0, idx)
    state = DisparityState(pose=take(pose), log_weights=lw_final,
                           w=take(new_w), px=take(new_px), py=take(new_py),
                           pz=take(new_pz), resample_idx=idx)
    return state, DispAux(expected_pose=exp_pose, neff=n_eff,
                          n_measure=n_measure)


def _update(state, pose, cloud_normals, z_uv, z_valid, n_measure,
            clutter_density, cfg):
    """Steps 2-8: the updated weights and clouds, and the particle log
    weight increment."""
    P, F, npp = state.px.shape
    M = z_uv.shape[0]
    dtype = state.w.dtype

    # ---- 2-3. world -> disparity, fitted 3-D Gaussians ----
    cam = pose[:, None, None, :]
    u, v, d, _ = world_to_disparity(state.px, state.py, state.pz, cam, cfg)
    m0, m1, m2, c00, c01, c02, c11, c12, c22 = fit_gaussians(u, v, d)
    del u, v, d

    # ---- 4. in-image gating on the fitted means ----
    in_fov = ((m0 > 0) & (m0 <= cfg.imageWidth) & (m1 >= 0)
              & (m1 <= cfg.imageHeight) & (m2 >= 0) & (state.w > 0))
    pd = torch.where(in_fov, cfg.pd, 0.0).to(dtype)
    # channels of empty or unseen slots: benign values, so no NaN leaks
    c00 = torch.where(in_fov, c00, 1.0)
    c11 = torch.where(in_fov, c11, 1.0)
    c22 = torch.where(in_fov, c22, 1.0)
    c01 = torch.where(in_fov, c01, 0.0)
    c02 = torch.where(in_fov, c02, 0.0)
    c12 = torch.where(in_fov, c12, 0.0)

    # ---- 5. EKF pre-update (H picks u, v); Joseph form ----
    var_u = cfg.stdU ** 2
    var_v = cfg.stdV ** 2
    s00 = c00 + var_u
    s01 = c01
    s11 = c11 + var_v
    det_s = torch.clamp(s00 * s11 - s01 * s01, min=var_u * var_v * 1e-6)
    si00 = s11 / det_s
    si01 = -s01 / det_s
    si11 = s00 / det_s
    k00 = c00 * si00 + c01 * si01
    k01 = c00 * si01 + c01 * si11
    k10 = c01 * si00 + c11 * si01
    k11 = c01 * si01 + c11 * si11
    k20 = c02 * si00 + c12 * si01
    k21 = c02 * si01 + c12 * si11
    l00 = 1.0 - k00
    l01 = -k01
    l10 = -k10
    l11 = 1.0 - k11
    q00 = l00 * c00 + l01 * c01
    q01 = l00 * c01 + l01 * c11
    q02 = l00 * c02 + l01 * c12
    q10 = l10 * c00 + l11 * c01
    q11 = l10 * c01 + l11 * c11
    q12 = l10 * c02 + l11 * c12
    u00 = q00 * l00 + q01 * l01 + k00 * k00 * var_u + k01 * k01 * var_v
    u01 = q00 * l10 + q01 * l11 + k00 * k10 * var_u + k01 * k11 * var_v
    u02 = ((-k20) * q00 + (-k21) * q01 + q02
           + k00 * k20 * var_u + k01 * k21 * var_v)
    u11 = q10 * l10 + q11 * l11 + k10 * k10 * var_u + k11 * k11 * var_v
    u12 = ((-k20) * q10 + (-k21) * q11 + q12
           + k10 * k20 * var_u + k11 * k21 * var_v)
    u22 = ((-k20) * (c02 * l00 + c12 * l01)
           + (-k21) * (c02 * l10 + c12 * l11)
           + (c22 - k20 * c02 - k21 * c12)
           + k20 * k20 * var_u + k21 * k21 * var_v)

    # ---- 6. detection log-weights [P, M, F] and the PHD update ----
    iu = z_uv[None, :, None, 0] - m0[:, None, :]
    iv = z_uv[None, :, None, 1] - m1[:, None, :]
    dist = torch.clamp(iu * iu * si00[:, None, :]
                       + 2 * iu * iv * si01[:, None, :]
                       + iv * iv * si11[:, None, :], min=0.0)
    lw = (safe_log(pd)[:, None, :] + safe_log(state.w)[:, None, :]
          - 0.5 * dist - LOG_2PI - 0.5 * torch.log(det_s)[:, None, :])
    del iu, iv, dist
    ok = in_fov[:, None, :] & z_valid[None, :, None]
    lw = torch.where(ok, lw, -math.inf)
    sum_exp = torch.exp(lw).sum(-1)                              # [P, M]
    normalizer = sum_exp + clutter_density + cfg.birthWeight
    log_norm = safe_log(normalizer)
    mvalid = z_valid.to(dtype)
    w_nd = torch.where(in_fov, state.w * (1.0 - pd), 0.0)
    w_det = torch.exp(lw - log_norm[..., None])
    del lw
    w_birth = torch.where(z_valid[None, :], cfg.birthWeight / normalizer,
                          0.0)
    if cfg.particleWeighting == 0:
        card_pred = (pd * state.w).sum(-1) + n_measure * cfg.birthWeight
        dw = (log_norm * mvalid[None, :]).sum(-1) - card_pred
    else:
        cn_pred = torch.where(in_fov, state.w, 0.0).sum(-1)
        cn_up = (w_nd.sum(-1) + (w_det * mvalid[None, :, None]).sum((-2, -1))
                 + (w_birth * mvalid[None, :]).sum(-1))
        dw = n_measure * clutter_density + cn_up - cn_pred - cfg.clutterRate

    # ---- 7. prune, pool [non-detections | top-k1 detections | births],
    # 3-D merge ----
    minw = cfg.minFeatureWeight
    prune = lambda a: torch.where(a >= minw, a, 0.0)
    k1 = min(8, F)
    w_sel, f_sel = top_k(prune(w_det), k1)                      # [P, M, k1]
    del w_det
    take_sel = lambda a: torch.gather(a[:, None, :].expand(P, M, F), 2, f_sel)
    iu_k = z_uv[None, :, None, 0] - take_sel(m0)
    iv_k = z_uv[None, :, None, 1] - take_sel(m1)
    det_m = [take_sel(m) + take_sel(ka) * iu_k + take_sel(kb) * iv_k
             for m, ka, kb in ((m0, k00, k01), (m1, k10, k11),
                               (m2, k20, k21))]
    zu_b = z_uv[None, :, 0].expand(P, M)
    zv_b = z_uv[None, :, 1].expand(P, M)
    full = lambda value: torch.full((P, M), value, dtype=dtype,
                                    device=z_uv.device)
    flat = lambda a: a.reshape(P, M * k1)
    cat3 = lambda a, b, c: torch.cat([a, flat(b), c], dim=-1)
    cand_w = cat3(prune(w_nd), prune(w_sel), prune(w_birth))
    if cfg.mergeMode == 1:
        cand_w = fast_prune_renormalize(cand_w, cfg.mergeMinWeight)
    merged = greedy_merge_channels3(
        cand_w, cat3(m0, det_m[0], zu_b), cat3(m1, det_m[1], zv_b),
        cat3(m2, det_m[2], full(cfg.disparityBirth)),
        cat3(c00, take_sel(u00), full(var_u)),
        cat3(c01, take_sel(u01), full(0.0)),
        cat3(c02, take_sel(u02), full(0.0)),
        cat3(c11, take_sel(u11), full(var_v)),
        cat3(c12, take_sel(u12), full(0.0)),
        cat3(c22, take_sel(u22), full(cfg.stdDBirth ** 2)),
        cfg.minSeparation, F)
    mw = merged[0]

    # ---- 8. merged Gaussians -> clouds -> world; union with the
    # out-of-view clouds ----
    su, sv, sd = sample_gaussians(cloud_normals, *merged[1:])
    nx, ny, nz = disparity_to_world(su, sv, sd, pose[:, None, None, :], cfg)
    del su, sv, sd
    w_out = torch.where(~in_fov & (state.w > 0), state.w, 0.0)
    top_w, u_idx = top_k(torch.cat([mw, w_out], dim=1), F)
    gidx = u_idx[..., None].expand(P, F, npp)
    pick = lambda a, b: torch.gather(torch.cat([a, b], dim=1), 1, gidx)
    return (top_w, pick(nx, state.px), pick(ny, state.py),
            pick(nz, state.pz), dw)


def map_summary(state: DisparityState, mesh=None):
    """The MAP particle's feature summary on the device: (w [F], cloud
    means [F, 3], cloud covariances [F, 3, 3], divided by Npp - 1); with a
    mesh the global MAP particle's, on every rank."""
    if mesh is None:
        idx = torch.argmax(state.log_weights).reshape(1)
        row = lambda t: t.index_select(0, idx)[0]
    else:
        idx = torch.argmax(gather_rows(state.log_weights, mesh))
        row = lambda t: global_row(t, idx, mesh)
    pts = torch.stack([row(state.px), row(state.py), row(state.pz)],
                      -1)                                         # [F, Npp, 3]
    mean = pts.mean(1)
    dlt = pts - mean[:, None]
    cov = torch.einsum("fni,fnj->fij", dlt, dlt) / max(pts.shape[1] - 1, 1)
    return row(state.w), mean, cov


def run_disparity_scan(state: DisparityState, zs, dt: float, cfg, *,
                       generator=None, noises=None,
                       with_map_log: bool = False, mesh=None):
    """``disparity_step`` over a whole dataset without reading the device.
    zs: T Measurements. Returns (final_state, (stacked DispAux, stacked
    (log_weights, poses, resample_idx)[, stacked (map_w, map_mean,
    map_cov)])); the map log is the MAP particle's ``map_summary``. With
    a mesh the state holds the rank's rows and the stacked values are
    global."""
    every = everywhere(mesh)[0]
    auxs, parts, maps = [], [], []
    for t, z in enumerate(zs):
        state, aux = disparity_step(
            state, z, dt, t > 0, cfg, generator=generator,
            noise=None if noises is None else noises[t], mesh=mesh)
        auxs.append(aux)
        parts.append((every(state.log_weights), every(state.pose),
                      every(state.resample_idx)))
        if with_map_log:
            maps.append(map_summary(state, mesh))
    stack = lambda rows: tuple(torch.stack(f) for f in zip(*rows))
    outs = (DispAux(*stack(auxs)), stack(parts))
    if with_map_log:
        outs = outs + (stack(maps),)
    return state, outs


def _map_world_gaussians(state: DisparityState):
    """World-frame Gaussians of the MAP particle's live features, on the
    host: (w [K], mean [K, 3], cov [K, 3, 3])."""
    w, mean, cov = (t.cpu().numpy() for t in map_summary(state))
    sel = w > 0
    return w[sel], mean[sel], cov[sel]


def run_disparity(cfg, args) -> dict:
    """The disparity runner: per step the expected camera pose and a
    state_estimate log (pose line the 12-DOF camera state, map line the MAP
    particle's world-frame Gaussians, stride 13), loopTime.log and
    metrics.jsonl (t, ms, neff, n_measure, card in both modes; JAX's scan
    mode writes no card); a NaN neff stops the run. In loop mode
    ``--checkpoint-every`` and ``--resume`` work as in the synth runner:
    the generator is restored after the initial jitter draw, so a resumed
    run draws what the straight run drew."""
    from phdslam_tpu_torch import checkpoint
    from phdslam_tpu_torch.io import loaders, logs

    device = torch.device(args.device)
    data_dir = args.data_dir or cfg.dataDirectory
    meas_path = args.measurements or os.path.join(data_dir,
                                                  "measurements.txt")
    sets = loaders.load_measurements(meas_path)      # (u, v) pairs per line
    n_steps = len(sets)
    if cfg.nSteps > 0:
        n_steps = min(n_steps, cfg.nSteps)
    rb, labels, valid = loaders.pad_measurement_sets(sets,
                                                     cfg.maxMeasurements)
    zs = [Measurements.from_numpy(rb[t], labels[t], valid[t], device)
          for t in range(n_steps)]
    dt = float(np.float32(cfg.dt))
    out_dir = args.out_dir
    os.makedirs(out_dir, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = DisparityState.create(cfg, device)
    # +-0.03 rad jitter on the initial roll and yaw
    jitter = torch.rand((cfg.n_particles, 2), generator=generator,
                        device=device) * 0.06 - 0.03
    pose = state.pose.clone()
    pose[:, 3] += jitter[:, 0]
    pose[:, 5] += jitter[:, 1]
    state = state.replace(pose=pose)
    host = lambda t: t.cpu().numpy()

    if args.mode == "scan":
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        final, (auxs, (lws, poses_p, ridx), maps) = run_disparity_scan(
            state, zs, dt, cfg, generator=generator, with_map_log=True)
        poses = host(auxs.expected_pose)              # waits for the device
        elapsed = time.perf_counter() - t0
        map_w, map_mean, map_cov = (host(m) for m in maps)
        neffs = host(auxs.neff)
        nan_steps = np.flatnonzero(~np.isfinite(neffs))
        t_valid = int(nan_steps[0]) if nan_steps.size else n_steps
        if t_valid < n_steps:
            print(f"nan weights detected at step {t_valid}! "
                  "truncating outputs...")
        ms_step = elapsed / n_steps * 1000
        lws, poses_p, ridx = host(lws), host(poses_p), host(ridx)
        n_meas = host(auxs.n_measure)
        for t in range(t_valid):
            logs.append_loop_time(out_dir, ms_step)
            sel = map_w[t] > 0
            if not args.no_logs:
                logs.write_state_estimate_log(
                    out_dir, t, poses[t], map_w[t][sel], map_mean[t][sel],
                    map_cov[t][sel], particle_log_weights=lws[t],
                    particle_poses=poses_p[t], resample_idx=ridx[t],
                    max_cardinality=cfg.maxCardinality)
            logs.append_metrics_jsonl(out_dir, dict(
                t=t, ms=ms_step, neff=float(neffs[t]),
                n_measure=int(n_meas[t]), card=float(map_w[t][sel].sum())))
        print(f"disparity scan: {n_steps} steps in {elapsed:.3f}s "
              f"({ms_step:.2f} ms/step)")
        return dict(state=final, poses=poses[:t_valid], ms_per_step=ms_step)

    poses_out = []
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    start_t = 0
    if args.resume:
        state, start_t = checkpoint.resume(ckpt_dir, device, generator,
                                           state)
    for t in range(start_t, n_steps):
        t0 = time.perf_counter()
        state, aux = disparity_step(state, zs[t], dt, t > 0, cfg,
                                    generator=generator)
        neff_val = float(aux.neff)                   # waits for the device
        elapsed_ms = (time.perf_counter() - t0) * 1000
        logs.append_loop_time(out_dir, elapsed_ms)
        exp_pose = host(aux.expected_pose)
        poses_out.append(exp_pose)
        mw, mmean, mcov = _map_world_gaussians(state)
        if not args.no_logs:
            logs.write_state_estimate_log(
                out_dir, t, exp_pose, mw, mmean, mcov,
                particle_log_weights=host(state.log_weights),
                particle_poses=host(state.pose),
                resample_idx=host(state.resample_idx),
                max_cardinality=cfg.maxCardinality)
        logs.append_metrics_jsonl(out_dir, dict(
            t=t, ms=elapsed_ms, neff=neff_val, n_measure=zs[t].count,
            card=float(mw.sum())))
        if args.checkpoint_every and t > 0 and t % args.checkpoint_every == 0:
            checkpoint.save_checkpoint(ckpt_dir, t, state, generator)
        if np.isnan(neff_val):
            print("nan weights detected! exiting...")
            break
        if args.verbose:
            print(f"step {t}/{n_steps} neff={neff_val:.3f} "
                  f"pose={exp_pose[:3]}")
    return dict(state=state, poses=np.asarray(poses_out))

"""Command-line entry point of the GM-PHD SLAM port.

    python -m phdslam_tpu_torch.runner <config.cfg> synth [profile] \\
        --measurements M.txt --controls C.txt --out-dir OUT \\
        [--mode loop|scan] [--device cuda|cpu] [--seed N] [--truth T] \\
        [--mat-export] [--predict-time] [--player] [--islands N] \\
        [--checkpoint-every K] [--resume]
    python -m phdslam_tpu_torch.runner <config.cfg> disparity \\
        [--data-dir D] --out-dir OUT [--mode loop|scan] [--device cuda|cpu] \\
        [--checkpoint-every K] [--resume]

It runs on the GPU (``--device cuda``, the default) and raises when CUDA is
missing; ``--device cpu`` runs the kernels' plain versions on the CPU.

Mirrors ``phdslam_tpu/runner.py::run_synth``: timestamp-interleaved input
scheduling when ``*_times.txt`` files exist and lockstep otherwise,
prediction skipped at step 0, the update only on steps with measurements,
and the same ``state_estimateXXXXX.log``, ``loopTime.log`` and
``metrics.jsonl`` files, written by ``io/logs.py`` (the JAX package's log
format). Under the dynamic and mixed feature models line 3 of each log holds
the dynamic map; under the CPHD filter (filter_type = 1) the last line holds
the MAP particle's cardinality log-pmf; under FastSLAM (filter_type = 2) the
map's weights are the MAP particle's landmark counters. The ``disparity``
run type runs the monocular SC-PHD pipeline
(``filter/disparity.py::run_disparity``).

``--mode loop`` steps in a Python loop and writes the logs after every step;
``--mode scan`` queues the whole run on the device, then writes the logs
from the stacked per-step outputs. The maps in the log are the MAP
particle's, or in loop mode under ``map_estimate & 2`` the EAP map (every
particle's map on the host each step, greedily reduced).

Loop mode also writes, as the JAX runner does: ``particlesXXXXX.mat`` with
``--mat-export`` or ``save_all_maps``, ``particles_predictXXXXX.mat`` (the
predicted particles the update consumes) under ``save_prediction``,
``predicttime.log`` with ``--predict-time``, and ``state100.pkl`` before
step 100 (a dict of numpy arrays: ``state`` as ``bridge.state_to_numpy``
writes it and ``z`` with ``rb``, ``label`` and ``valid``), which ``synth
profile`` replays. ``--truth`` adds an ``ospa`` column to ``metrics.jsonl``
in both modes; ``--player`` writes ``player.html`` after the run.

Checkpoints (loop mode, as in the JAX runner; scan mode ignores both
flags): ``--checkpoint-every K`` writes ``OUT/checkpoints/ckpt_<t>.npz``
after step t when t > 0 and t % K == 0 (the state and the generator's
state, ``checkpoint.py``; the last three kept). ``--resume`` restores the
latest one and runs from the step after it with the restored generator, so
the resumed steps draw what a straight run draws; their logs are appended
to those in OUT. As in JAX, the first resumed step has no previous
measurements (``z_prev`` is not restored): a CPHD run skips that step's
births and an informed mixed run its birth velocities.

``--islands N`` (N > 1, a power of 2 that divides n_particles) runs the
island model (``parallel/island.py``) on the one device: N blocks of
n_particles / N particles, each resampled locally, with butterfly
exchanges when the island nEff falls to 0.5. Loop mode logs as a plain
run does (the local log-weights and their MAP particle; ``neff`` is the
island nEff, ``resampled`` whether the exchange ran); a resume starts the
island weights uniform again (a checkpoint holds none, as in JAX). Scan
mode writes JAX's island scan logs (``_write_island_scan_log``).
``--variance`` is not computed in island mode.

Under torchrun (``WORLD_SIZE`` > 1) ``--islands N`` spreads the islands
over the ranks (``parallel/mesh.py``; W ranks dividing N, rank r holding
islands [r N/W, (r + 1) N/W)), in loop and scan mode:

    torchrun --nproc-per-node W -m phdslam_tpu_torch.runner CFG synth \
        ... --islands N [--mode scan] [--dist-backend gloo]

The backend follows ``--device``: NCCL on cuda (rank r on cuda:LOCAL_RANK
unless the device names an index), gloo on cpu; ranks that share one card
(``--device cuda:0``) need ``--dist-backend gloo``, since NCCL refuses
two ranks on one device. Every rank loads the same data and draws the
same draws; rank 0 writes every output the one-process run writes, with
the same bytes (the times aside), and the other ranks write nothing. The
run types and flags without a multi-rank form raise by name: the plain
(non-island) runner, ``disparity``, ``profile``, ``--checkpoint-every``
and ``--resume``. ``--predict-time`` times the rank's own prediction.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from phdslam_tpu_torch import checkpoint
from phdslam_tpu_torch.bridge import (host_view, state_from_numpy,
                                      state_to_numpy, unpack_cov_channels)
from phdslam_tpu_torch.config import CPHD_TYPE, load_config
from phdslam_tpu_torch.filter.disparity import run_disparity
from phdslam_tpu_torch.filter.estimate import eap_map_np
from phdslam_tpu_torch.filter.state import Measurements, SlamState
from phdslam_tpu_torch.filter.step import (StepAux, check_supported,
                                           draw_noise, log_aux,
                                           predicted_state, run_scan,
                                           slam_step)
from phdslam_tpu_torch.io import loaders, logs
from phdslam_tpu_torch.io.matdump import write_particles_mat
from phdslam_tpu_torch.ops.ospa import ospa_np
from phdslam_tpu_torch.parallel.island import (check_islands,
                                               draw_island_noise,
                                               init_islands,
                                               island_run_scan,
                                               island_slam_step)
from phdslam_tpu_torch.parallel.mesh import (make_mesh, shard_state,
                                             unshard_state)


def schedule_inputs(n_steps, meas_times, ctrl_times):
    """Per-step dict(z=measurement set, c=control index, dt, predict): the
    timestamp interleave when timestamps exist, else lockstep (measurement
    n with control n - 1). Same rule as ``phdslam_tpu.runner``."""
    sched = []
    if meas_times is None:
        for n in range(n_steps):
            sched.append(dict(z=n, c=n - 1 if n > 0 else None, dt=None,
                              predict=True))
        return sched
    z_idx, c_idx = 0, 0
    current_time = 0.0
    for _ in range(n_steps):
        if z_idx >= len(meas_times) or c_idx >= len(ctrl_times):
            break
        last = current_time
        if meas_times[z_idx] < ctrl_times[c_idx]:
            # measurement-only step: predict with the last consumed control
            current_time = ctrl_times[c_idx]
            sched.append(dict(z=z_idx, c=c_idx - 1 if c_idx > 0 else None,
                              dt=current_time - last, predict=True))
            z_idx += 1
        elif meas_times[z_idx] == ctrl_times[c_idx]:
            current_time = ctrl_times[c_idx]
            sched.append(dict(z=z_idx, c=c_idx, dt=current_time - last,
                              predict=True))
            z_idx += 1
            c_idx += 1
        else:
            current_time = ctrl_times[c_idx]
            sched.append(dict(z=None, c=c_idx, dt=current_time - last,
                              predict=True))
            c_idx += 1
    return sched


def load_truth_maps(path):
    """Ground-truth landmarks for the in-loop OSPA: a simData .mat (per-step
    visited landmarks, sim.groundTruth[t].loc [2, L_t]) or a text file of
    'x y' lines (one map for every step). Returns t -> [L, 2]."""
    if path.endswith(".mat"):
        from scipy.io import loadmat
        sim = loadmat(path)["sim"][0, 0]
        gt = sim["groundTruth"]
        maps = [np.asarray(gt[0, t][0, 0]["loc"], np.float64).T
                for t in range(gt.shape[1])]
        return lambda t: maps[min(t, len(maps) - 1)]
    pts = np.loadtxt(path, ndmin=2)[:, :2]
    return lambda t: pts


def _ospa_from_map(w, mx, my, truth_maps, t, p=1.0, c=5.0):
    """OSPA of one map against the truth at step t, the map cut to its top
    round(sum w) components; [ospa, loc, card]."""
    n_est = int(round(float(w.sum())))
    order = np.argsort(w)[::-1][:max(n_est, 0)]
    est = np.stack([mx[order], my[order]], axis=-1)
    o, loc, card = ospa_np(est, truth_maps(t), p=p, c=c)
    return [float(o), float(loc), float(card)]


def _map_for_log(view, mixture, cfg, eap):
    """The MAP (highest-weight particle's) or EAP map of one mixture of a
    host view, as (w, mean, cov) without empty slots."""
    if eap:
        return eap_map_np(view.log_weights, mixture.w, mixture.mean,
                          mixture.cov, cfg.minSeparation)
    idx = int(np.argmax(view.log_weights))
    sel = mixture.w[idx] > 0
    return mixture.w[idx][sel], mixture.mean[idx][sel], mixture.cov[idx][sel]


def _step_inputs(sched, controls, rb, labels, valid, cfg, device):
    """Host schedule -> per-step (control, Measurements, dt, do_predict)."""
    m = cfg.maxMeasurements
    out = []
    for t, s in enumerate(sched):
        if s["z"] is not None:
            z = Measurements.from_numpy(rb[s["z"]], labels[s["z"]],
                                        valid[s["z"]], device)
        else:
            z = Measurements.empty(m, device)
        c = s["c"]
        ctrl = ((float(controls[c, 0]), float(controls[c, 1]))
                if c is not None and c >= 0 else (0.0, 0.0))
        dt = float(np.float32(s["dt"] if s["dt"] is not None else cfg.dt))
        out.append((ctrl, z, dt, t > 0 and s["predict"]))
    return out


def _write_log(out_dir, t, exp_pose, la, repeat, cfg, est=None):
    """One state_estimate log from host copies of a LogAux: the MAP
    particle's static map on line 2 and, under the dynamic and mixed
    feature models, its dynamic map on line 3; under map_estimate & 2 the
    EAP maps of est (``_estimates``) instead."""
    has_dyn = cfg.featureModel != 0 and la["dyn_w"].shape[-1] > 0
    dyn = (None, None, None)
    if cfg.mapEstimate & 2 and est is not None:
        static = est["exp_map_static"]
        dyn = est.get("exp_map_dynamic", dyn)
    else:
        sel = la["map_w"] > 0
        cov = np.zeros((int(sel.sum()), 2, 2), np.float32)
        cov[:, 0, 0] = la["map_c00"][sel]
        cov[:, 0, 1] = cov[:, 1, 0] = la["map_c01"][sel]
        cov[:, 1, 1] = la["map_c11"][sel]
        static = (la["map_w"][sel], np.stack(
            [la["map_mx"][sel], la["map_my"][sel]], axis=-1), cov)
        if has_dyn:
            dsel = la["dyn_w"] > 0
            dyn = (la["dyn_w"][dsel], la["dyn_mean"].T[dsel],
                   unpack_cov_channels(la["dyn_cov"])[dsel])
    is_cphd = cfg.filterType == CPHD_TYPE
    logs.write_state_estimate_log(
        out_dir, t, exp_pose, *static, dynamic_w=dyn[0],
        dynamic_mean=dyn[1], dynamic_cov=dyn[2],
        particle_log_weights=la["log_weights"],
        particle_poses=la["poses"], resample_idx=la["resample_idx"],
        cardinality=la["cardinality"] if is_cphd else None,
        max_cardinality=cfg.maxCardinality, is_cphd=is_cphd, repeat=repeat)


def _write_island_scan_log(out_dir, t, pose, la, aux, cfg, ms,
                           truth_maps=None):
    """One step's log and metrics line of an island scan run, from host
    copies of its IslandLogAux and IslandAux rows, as JAX's
    ``_write_island_scan_logs`` writes them: the map of the island with the
    largest ``best_score``; every particle's global log-weight, pose and
    lineage; neff (the island nEff), exchanged, log_lik and card in the
    metrics (no dynamic map and no cardinality line)."""
    isl = int(np.argmax(la["best_score"]))
    w = la["best_w"][isl]
    sel = w > 0
    mx, my = la["best_mx"][isl], la["best_my"][isl]
    cov = np.zeros((int(sel.sum()), 2, 2), np.float32)
    cov[:, 0, 0] = la["best_c00"][isl][sel]
    cov[:, 0, 1] = cov[:, 1, 0] = la["best_c01"][isl][sel]
    cov[:, 1, 1] = la["best_c11"][isl][sel]
    logs.write_state_estimate_log(
        out_dir, t, pose, w[sel], np.stack([mx[sel], my[sel]], axis=-1), cov,
        particle_log_weights=la["log_weights"], particle_poses=la["poses"],
        resample_idx=la["resample_idx"], max_cardinality=cfg.maxCardinality,
        repeat=cfg.nPredictParticles if t == 0 else 1)
    metrics = dict(t=t, ms=ms, neff=float(aux["island_neff"]),
                   exchanged=bool(aux["exchanged"]),
                   log_lik=float(aux["log_lik"]), card=float(w.sum()))
    if truth_maps is not None:
        metrics["ospa"] = _ospa_from_map(w, mx, my, truth_maps, t)
    logs.append_metrics_jsonl(out_dir, metrics)


def _host(la) -> dict:
    return {k: v.cpu().numpy() for k, v in la._asdict().items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _estimates(view, cfg):
    """The map estimates of a host view: the MAP maps under map_estimate &
    1 and the EAP maps under & 2, dynamic ones where there is a dynamic
    map, keyed as ``write_particles_mat`` takes them."""
    has_dyn = cfg.featureModel != 0 and view.map_dynamic.max_features > 0
    est = {}
    for bit, name, eap in ((1, "max", False), (2, "exp", True)):
        if cfg.mapEstimate & bit:
            est[f"{name}_map_static"] = _map_for_log(view, view.map_static,
                                                     cfg, eap)
            if has_dyn:
                est[f"{name}_map_dynamic"] = _map_for_log(
                    view, view.map_dynamic, cfg, eap)
    return est


def run_synth(cfg, args, mesh=None) -> dict:
    """The synth run; with a mesh (``main`` under torchrun) the island
    run across its ranks, rank 0 writing the outputs."""
    check_supported(cfg)
    device = torch.device(args.device) if mesh is None else mesh.device
    writer = mesh is None or mesh.rank == 0
    every = (lambda s: s) if mesh is None else \
        (lambda s: unshard_state(s, mesh))
    data_dir = args.data_dir or cfg.dataDirectory
    meas_path = args.measurements or os.path.join(data_dir,
                                                  "measurements.txt")
    ctrl_path = args.controls or os.path.join(data_dir, "controls.txt")
    meas_sets = loaders.load_measurements(meas_path,
                                          labeled=cfg.labeledMeasurements)
    controls = loaders.load_controls(ctrl_path)
    meas_times = loaders.load_timestamps(
        os.path.join(data_dir, "measurement_times.txt"))
    ctrl_times = loaders.load_timestamps(
        os.path.join(data_dir, "control_times.txt"))

    traj = None
    if cfg.followTrajectory:
        # one particle driven along the given trajectory
        traj = loaders.load_trajectory(os.path.join(data_dir, "traj.txt"))
        cfg = cfg.replace(n_particles=1)
    # island mode, as in JAX, from 2 islands up
    n_isl = args.islands if args.islands > 1 else 0
    if n_isl:
        check_islands(cfg, n_isl, mesh)

    n_steps = len(meas_sets)
    if meas_times is not None:
        n_steps = len(meas_times) + len(ctrl_times)
    if cfg.nSteps > 0:
        n_steps = min(n_steps, cfg.nSteps)
    n_steps = min(n_steps, cfg.maxSteps)

    rb, labels, valid = loaders.pad_measurement_sets(meas_sets,
                                                     cfg.maxMeasurements)
    out_dir = args.out_dir
    if writer:
        os.makedirs(out_dir, exist_ok=True)
    truth_maps = load_truth_maps(args.truth) if args.truth else None
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if n_isl:
        state, island_logw = init_islands(cfg, n_isl, device)
        if mesh is not None:
            state = shard_state(state, mesh)
    else:
        state = SlamState.create(cfg, device)
    sched = schedule_inputs(n_steps, meas_times, ctrl_times)
    steps = _step_inputs(sched, controls, rb, labels, valid, cfg, device)
    repeat0 = cfg.nPredictParticles

    if args.mode == "scan":
        if traj is not None:
            raise NotImplementedError(
                "follow_trajectory runs in loop mode only")
        ctrls, zs, dts = ([s[i] for s in steps] for i in range(3))
        _sync(device)
        t0 = time.perf_counter()
        if n_isl:
            final, _, auxs, las = island_run_scan(
                state, island_logw, ctrls, zs, dts, cfg, n_isl,
                generator=generator, with_log_state=True, mesh=mesh)
        else:
            final, (auxs, las) = run_scan(
                state, ctrls, zs, dts, cfg, generator=generator,
                with_log_state=True, with_variance=args.variance)
        poses = auxs.expected_pose.cpu().numpy()     # waits for the device
        elapsed = time.perf_counter() - t0
        t_len = len(steps)
        ms = elapsed / t_len * 1000
        neffs = (auxs.island_neff if n_isl else auxs.neff).cpu().numpy()
        nan_steps = np.flatnonzero(~np.isfinite(neffs))
        t_valid = int(nan_steps[0]) if nan_steps.size else t_len
        if t_valid < t_len:
            print(f"nan weights detected at step {t_valid}! "
                  "truncating outputs...")
        aux_h = {k: v.cpu().numpy() for k, v in auxs._asdict().items()}
        la_h = _host(las)
        for t in range(t_valid if writer else 0):
            logs.append_loop_time(out_dir, ms)
            if args.no_logs:
                continue
            la_t = {k: v[t] for k, v in la_h.items()}
            if n_isl:
                _write_island_scan_log(out_dir, t, poses[t], la_t,
                                       {k: v[t] for k, v in aux_h.items()},
                                       cfg, ms, truth_maps)
                continue
            _write_log(out_dir, t, poses[t], la_t,
                       repeat0 if t == 0 else 1, cfg)
            metrics = dict(
                t=t, ms=ms, neff=float(aux_h["neff"][t]),
                n_measure=int(aux_h["n_measure"][t]),
                resampled=bool(aux_h["resampled"][t]),
                log_lik=float(aux_h["log_lik"][t]),
                card=float(la_t["map_w"].sum()))
            if truth_maps is not None:
                metrics["ospa"] = _ospa_from_map(
                    la_t["map_w"], la_t["map_mx"], la_t["map_my"],
                    truth_maps, t)
            logs.append_metrics_jsonl(out_dir, metrics)
        if writer:
            print(f"scan: {t_len} steps in {elapsed:.3f}s ({ms:.2f} "
                  "ms/step)")
        return dict(state=final, poses=poses, aux=auxs, ms_per_step=ms,
                    nan_step=t_valid if t_valid < t_len else None)

    if n_isl and writer:
        print(f"island mode: {n_isl} islands x {cfg.n_particles // n_isl} "
              "particles" + ("" if mesh is None else
                             f" on {mesh.world_size} ranks"))
    poses_out = []
    z_prev = None
    n_predicted = cfg.n_particles * max(int(cfg.nPredictParticles), 1)
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    start_t = 0
    if args.resume:
        # the island weights start uniform again: a checkpoint holds none
        # (as in JAX)
        state, start_t = checkpoint.resume(ckpt_dir, device, generator,
                                           state)
    for t, (ctrl, z, dt, do_predict) in enumerate(steps):
        if t < start_t:
            continue
        if traj is not None and t < len(traj):
            state = state.replace(pose=torch.as_tensor(
                traj[t], device=device).expand_as(state.pose).clone())
            do_predict = False
        # the step's draws, made here once: the prediction written or timed
        # below is the one the step consumes, and the generator advances as
        # in a run without those outputs
        if n_isl:
            noise = draw_island_noise(cfg, n_isl, device, generator,
                                      state.log_weights.dtype)
        else:
            noise = draw_noise(cfg, n_predicted, device, generator,
                               state.log_weights.dtype)
        # the rank's rows of the pose normals (all of them on one rank)
        own_noise = noise if mesh is None \
            else (mesh.local(noise[0], 1),) + tuple(noise[1:])
        if cfg.savePrediction:
            pred = every(predicted_state(state, ctrl, dt, do_predict, cfg,
                                         own_noise))
            if writer:
                write_particles_mat(out_dir, t, host_view(pred),
                                    prefix="particles_predict")
        if t == 100 and args.checkpoint:
            full = state_to_numpy(every(state))
            if writer:
                with open(os.path.join(out_dir, "state100.pkl"), "wb") as f:
                    pickle.dump(dict(state=full, z=dict(
                        rb=z.rb.cpu().numpy(), label=z.label.cpu().numpy(),
                        valid=z.valid.cpu().numpy())), f)
        if args.predict_time and do_predict:
            _sync(device)
            t_pred = time.perf_counter()
            predicted_state(state, ctrl, dt, True, cfg, own_noise)
            _sync(device)
            if writer:
                logs.append_predict_time(
                    out_dir, (time.perf_counter() - t_pred) * 1000)
        t0 = time.perf_counter()
        if n_isl:
            # the step log keeps the local log-weights and their argmax,
            # as JAX's island loop does
            state, island_logw, iaux = island_slam_step(
                state, island_logw, ctrl, z, dt, do_predict, cfg, n_isl,
                noise=noise, z_prev=z_prev, mesh=mesh)
            aux = StepAux(expected_pose=iaux.expected_pose,
                          neff=iaux.island_neff, resampled=iaux.exchanged,
                          n_measure=z.count, log_lik=iaux.log_lik)
        else:
            state, aux = slam_step(state, ctrl, z, dt, do_predict, cfg,
                                   noise=noise, with_variance=args.variance,
                                   z_prev=z_prev)
        z_prev = z
        neff_val = float(aux.neff)                   # waits for the device
        elapsed_ms = (time.perf_counter() - t0) * 1000
        exp_pose = aux.expected_pose.cpu().numpy()
        la = _host(log_aux(state, mesh=mesh))
        mat = args.mat_export or cfg.saveAllMaps
        view = est = None
        if mat or cfg.mapEstimate & 2 and not args.no_logs:
            # every particle's map on the host, its estimates once a step
            view = host_view(every(state))
            est = _estimates(view, cfg) if writer else None
        if writer:
            logs.append_loop_time(out_dir, elapsed_ms)
            if not args.no_logs:
                _write_log(out_dir, t, exp_pose, la,
                           repeat0 if t == 0 else 1, cfg, est)
            metrics = dict(
                t=t, ms=elapsed_ms, neff=neff_val, n_measure=z.count,
                resampled=bool(aux.resampled), log_lik=float(aux.log_lik),
                card=float(la["map_w"].sum()))
            if truth_maps is not None:
                metrics["ospa"] = _ospa_from_map(la["map_w"], la["map_mx"],
                                                la["map_my"], truth_maps, t)
            logs.append_metrics_jsonl(out_dir, metrics)
            if mat:
                write_particles_mat(out_dir, t, view, **est)
        poses_out.append(exp_pose)
        if args.checkpoint_every and t > 0 and t % args.checkpoint_every == 0:
            checkpoint.save_checkpoint(ckpt_dir, t, state, generator)
        if np.isnan(neff_val):
            print("nan weights detected! exiting...")
            break
        if args.verbose and writer:
            print(f"step {t}/{len(steps)} ms={elapsed_ms:.1f} "
                  f"neff={neff_val:.3f}")
    res = dict(state=state, poses=np.asarray(poses_out))
    if n_isl:
        res["island_logw"] = island_logw
    return res


def run_profile(cfg, args):
    """Replay the step-100 fixture (out-dir/state100.pkl) through two
    steps, printing each one's milliseconds (the first includes the
    kernels' build and load)."""
    with open(os.path.join(args.out_dir, "state100.pkl"), "rb") as f:
        d = pickle.load(f)
    device = torch.device(args.device)
    state = state_from_numpy(d["state"], device)
    z = Measurements.from_numpy(d["z"]["rb"], d["z"]["label"],
                                d["z"]["valid"], device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    times = []
    for what in ("first", "second"):
        _sync(device)
        t0 = time.perf_counter()
        out, _ = slam_step(state, (0.0, 0.0), z, float(cfg.dt), True, cfg,
                           generator=generator)
        out.log_weights.cpu()
        times.append((time.perf_counter() - t0) * 1000)
        print(f"profile step: {times[-1]:.2f} ms ({what})")
    return dict(ms=times)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("run_type", nargs="?", default="synth",
                    choices=["synth", "disparity"])
    ap.add_argument("profile", nargs="?", default="",
                    help="'profile' replays the step-100 fixture "
                         "(out-dir/state100.pkl)")
    ap.add_argument("--mode", default="loop", choices=["loop", "scan"])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--measurements", default=None)
    ap.add_argument("--controls", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-logs", action="store_true")
    ap.add_argument("--checkpoint", action="store_true", default=True,
                    help="write the step-100 fixture state100.pkl (always "
                         "on, as in the JAX runner)")
    ap.add_argument("--mat-export", action="store_true",
                    help="write particlesXXXXX.mat each step (loop mode; "
                         "save_all_maps does the same)")
    ap.add_argument("--predict-time", action="store_true",
                    help="also time the prediction alone each step -> "
                         "predicttime.log (loop mode)")
    ap.add_argument("--variance", action="store_true",
                    help="compute the per-particle cardinality variance")
    ap.add_argument("--truth", default=None,
                    help="ground-truth landmarks (simData .mat or 'x y' "
                         "text) -> per-step OSPA column in metrics.jsonl")
    ap.add_argument("--player", action="store_true",
                    help="after the run, bundle the out-dir's logs into "
                         "out-dir/player.html (eval/player.py)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="write out-dir/checkpoints/ckpt_<t>.npz after every "
                         "step t > 0 with t %% K == 0 (loop mode)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in "
                         "out-dir/checkpoints (loop mode)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--islands", type=int, default=0,
                    help="run N > 1 islands of n_particles / N particles "
                         "on the one device, or spread over the ranks under "
                         "torchrun, with butterfly exchanges when the "
                         "island nEff falls to 0.5 (parallel/island.py;"
                         " loop and scan mode; --variance is not computed)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="under torchrun: the process group's backend "
                         "(default nccl on cuda, gloo on cpu; gloo for "
                         "ranks sharing one card, --device cuda:0)")
    return ap


def _multi_rank_refusals(args):
    """NotImplementedError for what has no multi-rank form."""
    for refused, what in (
            (args.run_type == "disparity", "the disparity run type"),
            (args.profile == "profile", "synth profile"),
            (args.checkpoint_every, "--checkpoint-every"),
            (args.resume, "--resume"),
            (args.islands <= 1, "the plain (non-island) runner; pass "
                                "--islands N")):
        if refused:
            raise NotImplementedError(
                f"{what} runs in one process only, not under torchrun "
                "(WORLD_SIZE > 1)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: CUDA is not available; pass --device "
            "cpu to run the kernels' plain versions on the CPU")
    cfg = load_config(args.config)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        _multi_rank_refusals(args)
        mesh = make_mesh(args.dist_backend, args.device)
        try:
            res = run_synth(cfg, args, mesh)
        finally:
            mesh.close()
        if mesh.rank:
            return res
    elif args.dist_backend:
        raise ValueError("--dist-backend applies under torchrun "
                         "(WORLD_SIZE > 1) only")
    elif args.run_type == "disparity":
        res = run_disparity(cfg, args)
    elif args.profile == "profile":
        res = run_profile(cfg, args)
    else:
        res = run_synth(cfg, args)
    if args.player and not args.no_logs:
        from phdslam_tpu_torch.eval.player import build_player
        truth = args.truth if args.truth else (
            (args.data_dir or cfg.dataDirectory)
            if args.run_type == "disparity" else None)
        try:
            print(f"player: {build_player(args.out_dir, truth_mat=truth)}")
        except FileNotFoundError as e:
            print(f"player skipped: {e}")
    return res


if __name__ == "__main__":
    main()

"""Monte-Carlo envelopes and wall times on the port: the phases of
``scripts/round3_evidence.py`` through ``eval/batch.py::run_batch``.

    python3 -m phdslam_tpu_torch.evidence.round3 [phase ...] [--quick]
        [--device cuda|cpu] [--plot] [--cpu-steps N]

Phases (all when none is named), each merged into the results file under
the script's key:

  vmap      run_batch vmapped against sequential, 50 runs x 331 steps at
            256 particles, two passes each (the second warm); the gap
            between the two paths' mean pose curves; the same at 32
            particles (maps unscored) and at merge_mode 1 -> "vmap"
  merge     exact, fast (merge_mode 1) and fast top-2 merge envelopes, 24
            runs x 331 steps -> "merge_modes"
  variants  PHD, CPHD, particle weighting 1 and 2, CPHD with the
            convolution cardinality predict, 20 runs x 201 steps ->
            "variants"
  parity    the port at 64 particles against the NumPy CPU reference
            (reference_cpu.run) on the same 20 re-noised runs x 151 steps
            -> "parity_config2"
  cphd_cpu  the CPU CPHD reference at 16 particles against one run of
            the port, 101 steps -> "cphd_cpu_oracle"

--quick: the script's 6 runs x 61 steps (variants 4 x 41, parity 3 x 41,
cphd_cpu 31 steps). The CPU legs run in this process, in the script's
order (parity after the port's runs, cphd_cpu before its run);
--cpu-steps cuts them, and the entry then names the cut (cpu_steps). The keys named tpu_* hold the port's numbers (the
script's names)."""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from phdslam_tpu_torch.evidence import common as C

PATHS = (("vmapped", True), ("sequential", False))
MERGE_ARMS = ((dict(mergeMode=0), "exact merge"),
              (dict(mergeMode=1), "fast merge"),
              (dict(mergeMode=1, selectTopK=2), "fast merge k2"))
SMALL_P = (32,)


def variant_arms(cfg):
    """(label, cfg) of the variants phase: both filters with ungated
    births, particle weighting 0 (the cfg's), 1 and 2, and CPHD with the
    convolution predict."""
    return [
        ("PHD", cfg),
        ("CPHD", cfg.replace(filterType=1, maxCardinality=127)),
        ("PHD w1", cfg.replace(particleWeighting=1)),
        ("PHD w2", cfg.replace(particleWeighting=2)),
        ("CPHD conv", cfg.replace(filterType=1, maxCardinality=127,
                                  cnPoissonPredict=False)),
    ]


def _key(label: str) -> str:
    return label.replace(" ", "_")


# ---------------------------------------------------------- statistics --

def envelope_gap(results) -> float:
    """The largest gap between the vmapped and sequential mean pose
    curves."""
    pe_v = np.stack([r.pose_err for r in results["vmapped"]]).mean(0)
    pe_s = np.stack([r.pose_err for r in results["sequential"]]).mean(0)
    return float(np.max(np.abs(pe_v - pe_s)))


def _walls(times) -> dict:
    return dict(
        wall_s_vmapped=round(times["vmapped"][1], 1),
        wall_s_sequential=round(times["sequential"][1], 1),
        wall_s_cold=dict(vmapped=round(times["vmapped"][0], 1),
                         sequential=round(times["sequential"][0], 1)),
        speedup=round(times["sequential"][1] / times["vmapped"][1], 2))


def vmap_entry(n_runs, steps, times, results, probe_times, fast_times,
               fast_results) -> dict:
    """times / fast_times: path -> [cold s, warm s]; results /
    fast_results: path -> RunResults; probe_times: particles -> path ->
    [s, s]. Beside the script's keys, each path's late-half mean pose
    error (pose_late_mean_vmapped, pose_late_mean_sequential)."""
    probe = {f"p{p}": dict(
        vmapped_s=round(t["vmapped"][1], 1),
        sequential_s=round(t["sequential"][1], 1),
        speedup=round(t["sequential"][1] / t["vmapped"][1], 2))
        for p, t in probe_times.items()}
    fast = dict(n_runs=n_runs, merge_mode=1, **_walls(fast_times),
                pose_envelope_max_abs_dev_m=round(
                    envelope_gap(fast_results), 4))
    late = {f"pose_late_mean_{path}": float(C.late_half(np.stack(
        [r.pose_err for r in res]).mean(0), steps).mean())
        for path, res in results.items()}
    return dict(n_runs=n_runs, steps=steps, **_walls(times),
                pose_envelope_max_abs_dev_m=round(envelope_gap(results), 4),
                small_p_probe=probe, fast_merge_probe=fast, **late)


def merge_entry(aggs: dict, t_len: int, n_runs: int) -> dict:
    """aggs: arm label -> aggregate."""
    out = {_key(k): C.late_stats(a, t_len, final=True)
           for k, a in aggs.items()}
    exact = out["exact_merge"]
    for flag, arm in (("within_one_std", "fast_merge"),
                      ("k2_within_one_std", "fast_merge_k2")):
        d = abs(out[arm]["ospa_late_mean"] - exact["ospa_late_mean"])
        out[flag] = bool(d <= exact["ospa_late_std"])
    out["n_runs"] = n_runs
    return out


def variants_entry(aggs: dict, t_len: int, n_runs: int) -> dict:
    out = {}
    for label, agg in aggs.items():
        entry = C.late_stats(agg, t_len)
        if "card_err_mean" in agg:
            entry.update(
                card_err_late_mean=float(
                    C.late_half(agg["card_err_mean"], t_len).mean()),
                card_err_final=float(agg["card_err_mean"][-1]),
                visited_final=float(agg["card_true"][-1]))
        out[_key(label)] = entry
    out["n_runs"] = n_runs
    out["steps"] = t_len
    return out


def parity_entry(agg_gpu, pe_cpu, cpu_ms, n_runs, t_len, n_particles,
                 cut=None) -> dict:
    """pe_cpu [R, T'] the CPU reference's pose errors, cpu_ms its ms per
    step a run; cut: the CPU leg's steps when it was cut."""
    pe_cpu = np.asarray(pe_cpu)
    m_t = float(C.late_half(agg_gpu["pose_err_mean"], t_len).mean())
    m_c = float(C.late_half(pe_cpu.mean(0), pe_cpu.shape[1]).mean())
    s_c = float(C.late_half(pe_cpu.std(0), pe_cpu.shape[1]).mean())
    out = dict(n_runs=n_runs, steps=t_len, n_particles=n_particles,
               tpu_pose_late_mean=round(m_t, 3),
               cpu_pose_late_mean=round(m_c, 3),
               cpu_pose_late_std=round(s_c, 3),
               within_one_std=bool(abs(m_t - m_c) <= s_c),
               cpu_ms_per_step=round(float(np.mean(cpu_ms)), 1))
    if cut:
        out["cpu_steps"] = cut
    return out


def cphd_cpu_entry(n_p, t_len, cpu, result, visited, cut=None) -> dict:
    """cpu: (pose errors, ms per step, final MAP map mass) of the CPU
    reference; result: the port's RunResult."""
    pe, cpu_ms, card = cpu
    out = dict(
        n_particles=n_p, steps=t_len,
        cpu_ms_per_step=round(cpu_ms, 1),
        cpu_pose_mean=round(float(pe.mean()), 3),
        cpu_card_final=round(float(card), 2),
        tpu_pose_mean=round(float(result.pose_err.mean()), 3),
        tpu_card_final=round(float(result.card_est[-1]), 2)
        if result.card_est is not None else None,
        visited_final=visited)
    if cut:
        out["cpu_steps"] = cut
    return out


# ------------------------------------------------------- CPU reference --

def map_mass(particles) -> float:
    """The MAP particle's intensity mass (RunResult.card_est's meaning)."""
    i = int(np.argmax([p.log_weight for p in particles]))
    return particles[i].w.sum()


def parity_cpu_run(cfg_cpu, sc, run, t_len):
    """One CPU reference run on run_batch's re-noising of run ``run``:
    (pose errors [t_len], ms per step)."""
    from phdslam_tpu_torch import reference_cpu as R
    from phdslam_tpu_torch.simdata import generate_run
    rng = np.random.default_rng(0 + 1000 * run)
    controls, meas = generate_run(rng, sc, C.CONTROL_NOISE)
    t0 = time.perf_counter()
    poses = R.run(cfg_cpu, controls[: t_len - 1], meas[:t_len], seed=run)
    ms = (time.perf_counter() - t0) / t_len * 1000
    return C.pose_errors(poses, sc.traj), ms


def cphd_cpu_run(cfg_cpu, sc, t_len):
    """The CPU CPHD reference on run 0's stream: (pose errors, ms per
    step, the final MAP map mass)."""
    from phdslam_tpu_torch import reference_cpu as R
    from phdslam_tpu_torch.simdata import generate_run
    controls, meas = generate_run(np.random.default_rng(0), sc,
                                  C.CONTROL_NOISE)
    snap = {}

    def cb(t, slam):
        snap[t] = map_mass(slam.particles)

    t0 = time.perf_counter()
    poses = R.run(cfg_cpu, controls[: t_len - 1], meas[:t_len], seed=0,
                  callback=cb)
    ms = (time.perf_counter() - t0) / t_len * 1000
    return C.pose_errors(poses, sc.traj), ms, snap[max(snap)]


# -------------------------------------------------------------- phases --

def _sizes(opts, quick, full, smoke):
    return smoke if opts.smoke else quick if opts.quick else full


def _batch(opts, cfg, sc, n_runs, **kw):
    from phdslam_tpu_torch.eval import batch as B
    return B.run_batch(cfg, sc, n_runs=n_runs, control_noise=C.CONTROL_NOISE,
                       device=opts.dev, **kw)


def _aggregate(res):
    import warnings

    from phdslam_tpu_torch.eval import batch as B
    with warnings.catch_warnings():        # steps no run scored: NaN
        warnings.simplefilter("ignore", RuntimeWarning)
        return B.aggregate(res)


def _timed_paths(opts, cfg, sc, n_runs, every):
    """Both paths, two passes each: (path -> [s, s], path -> RunResults
    of the second pass)."""
    times, results = {}, {}
    for label, vmapped in PATHS:
        per_pass = []
        for _ in range(2):
            t0 = time.perf_counter()
            res = _batch(opts, cfg, sc, n_runs, vmapped=vmapped,
                         collect_maps_every=every)
            per_pass.append(time.perf_counter() - t0)
        times[label], results[label] = per_pass, res
    return times, results


def phase_vmap(opts):
    cfg = C.mc_base_cfg(opts.smoke)
    sc = C.mc_scenario(_sizes(opts, 60, 330, 8))
    n_runs = _sizes(opts, 6, 50, 2)
    times, results = _timed_paths(opts, cfg, sc, n_runs, 4)
    probe_times = {p: _timed_paths(opts, cfg.replace(n_particles=p), sc,
                                   n_runs, 0)[0] for p in SMALL_P}
    fast_times, fast_results = _timed_paths(
        opts, cfg.replace(mergeMode=1), sc, n_runs, 4)
    return dict(vmap=vmap_entry(n_runs, sc.traj.shape[0], times, results,
                                probe_times, fast_times, fast_results))


def phase_merge(opts):
    cfg = C.mc_base_cfg(opts.smoke)
    sc = C.mc_scenario(_sizes(opts, 60, 330, 8))
    n_runs = _sizes(opts, 6, 24, 2)
    aggs = {label: _aggregate(_batch(opts, cfg.replace(**repl), sc, n_runs,
                                     collect_maps_every=4))
            for repl, label in MERGE_ARMS}
    if opts.plot:
        C.plot(list(aggs.values()), "port_merge_mode_envelopes", list(aggs),
               opts.out)
    return dict(merge_modes=merge_entry(aggs, sc.traj.shape[0], n_runs))


def phase_variants(opts):
    cfg = C.mc_base_cfg(opts.smoke)
    sc = C.mc_scenario(_sizes(opts, 40, 200, 8))
    n_runs = _sizes(opts, 4, 20, 2)
    aggs = {label: _aggregate(_batch(opts, c, sc, n_runs,
                                     collect_maps_every=4))
            for label, c in variant_arms(cfg)}
    if opts.plot:
        C.plot(list(aggs.values()), "port_variant_envelopes", list(aggs),
               opts.out)
    return dict(variants=variants_entry(aggs, sc.traj.shape[0], n_runs))


def phase_parity(opts):
    cfg = C.mc_base_cfg(opts.smoke).replace(
        n_particles=16 if opts.smoke else 64)
    sc = C.mc_scenario(_sizes(opts, 40, 150, 8))
    n_runs = _sizes(opts, 3, 20, 2)
    t_len = sc.traj.shape[0]
    t_cpu = C.cut(t_len, opts.cpu_steps)
    cfg_cpu = C.start_pose(cfg, sc.traj)
    agg = _aggregate(_batch(opts, cfg, sc, n_runs, collect_maps_every=0))
    cpu = [parity_cpu_run(cfg_cpu, sc, run, t_cpu) for run in range(n_runs)]
    pe_cpu = np.stack([pe for pe, _ in cpu])
    if opts.plot:
        C.plot([agg, dict(pose_err_mean=pe_cpu.mean(0),
                          pose_err_std=pe_cpu.std(0))],
               "port_parity_envelopes", ["port", "CPU reference (f64)"],
               opts.out)
    return dict(parity_config2=parity_entry(
        agg, pe_cpu, [ms for _, ms in cpu], n_runs, t_len, cfg.n_particles,
        t_cpu if t_cpu != t_len else None))


def phase_cphd_cpu(opts):
    from phdslam_tpu_torch.eval.batch import visited_landmarks
    n_p = 16
    cfg = C.mc_base_cfg(opts.smoke).replace(
        n_particles=n_p, filterType=1, maxCardinality=127)
    sc = C.mc_scenario(_sizes(opts, 30, 100, 8))
    t_len = sc.traj.shape[0]
    t_cpu = C.cut(t_len, opts.cpu_steps)
    cfg_cpu = C.start_pose(cfg, sc.traj)
    cpu = cphd_cpu_run(cfg_cpu, sc, t_cpu)
    res = _batch(opts, cfg, sc, 1, collect_maps_every=4)
    visited = len(visited_landmarks(sc)[t_len - 1])
    return dict(cphd_cpu_oracle=cphd_cpu_entry(
        n_p, t_len, cpu, res[0], visited,
        t_cpu if t_cpu != t_len else None))


PHASES = dict(vmap=phase_vmap, merge=phase_merge, variants=phase_variants,
              parity=phase_parity, cphd_cpu=phase_cphd_cpu)


def main(argv=None) -> dict:
    """Run the named phases (all by default); returns key -> entry."""
    ap = C.parser(__doc__.split("\n")[0], plot=True)
    ap.add_argument("phases", nargs="*",
                    help=f"of {', '.join(PHASES)} (default: all)")
    C.add_cpu_leg_flags(ap)
    opts = ap.parse_args(argv)
    unknown = set(opts.phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    opts.dev = C.resolve_device(opts.device)
    fields = C.device_fields(opts.dev)
    out = {}
    for name in opts.phases or list(PHASES):
        print(f"=== phase {name} ===", flush=True)
        update = PHASES[name](opts)
        if opts.smoke:
            update = {k: dict(v, **fields) for k, v in update.items()}
            print(json.dumps(update), flush=True)
        else:
            update = C.merge_json(update, opts.out, fields)
        out.update(update)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])

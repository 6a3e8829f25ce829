"""The port's runner on the CPU over a small self-generated ``simdata`` run
(the scenario of tests/test_e2e.py): the log contract, and tracking within
that test's bar (mean pose error < 2.0 m). No reference data is read."""

import json
import os

import numpy as np
import pytest
import torch

from phdslam_tpu_torch import runner, simdata
from phdslam_tpu_torch.io.logs import read_state_estimate_log

torch.set_num_threads(1)

T = 40
TINY = """
n_particles = 8
max_features = 16
max_measurements = 8
birth_weight = 0.02
std_encoder = 0.05
std_alpha = 0.005
initial_y = 0.0
"""


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    sc = simdata.make_scenario(np.random.default_rng(11), n_landmarks=12,
                               n_steps=T, clutter_rate=2.0)
    # seed 21: every step has a measurement (the shared text loader skips
    # an empty line, which would shift the steps against the truth)
    controls, meas = simdata.generate_run(np.random.default_rng(21), sc,
                                          control_noise=(0.05, 0.005))
    assert all(len(z) for z in meas[:T])
    d = tmp_path_factory.mktemp("simrun")
    simdata.write_run_files(str(d), controls, meas[:T])
    with open("cfg/ackerman_synth.cfg") as f:
        base = f.read()
    (d / "tiny.cfg").write_text(base + TINY)
    return sc, d


def _args(d, out, *extra):
    return [str(d / "tiny.cfg"), "synth", "--measurements",
            str(d / "measurements.txt"), "--controls",
            str(d / "controls.txt"), "--out-dir", str(out), "--device",
            "cpu", *extra]


@pytest.mark.parametrize("mode", ["loop", "scan"])
def test_runner_log_contract_and_tracking(dataset, tmp_path, mode):
    sc, d = dataset
    out = tmp_path / mode
    runner.main(_args(d, out, "--mode", mode, "--seed", "3"))
    logs = sorted(p for p in os.listdir(out)
                  if p.startswith("state_estimate"))
    assert logs == [f"state_estimate{t:05d}.log" for t in range(T)]
    with open(out / "loopTime.log") as f:
        assert len(f.read().split()) == T
    with open(out / "metrics.jsonl") as f:
        metrics = [json.loads(line) for line in f]
    assert [m["t"] for m in metrics] == list(range(T))
    assert all(np.isfinite(m["neff"]) for m in metrics)
    errs = []
    for t in range(T):
        log = read_state_estimate_log(
            str(out / f"state_estimate{t:05d}.log"))
        assert log["weights"].shape == (8,)
        assert log["poses"].shape == (8, 6)
        assert log["resample_idx"].shape == (8,)
        assert log["static"].shape[1] == 7
        errs.append(np.linalg.norm(log["pose"][:2] - sc.traj[t, :2]))
    errs = np.asarray(errs)
    assert np.isfinite(errs).all()
    assert errs.mean() < 2.0, errs
    # landmarks were mapped: the last MAP map holds mass
    assert log["static"][:, 0].sum() > 0.5


def _traj_rows(n):
    return [f"{0.5 * t} {0.25 * t} 0.1 0 0 0" for t in range(n)]


@pytest.mark.parametrize("extra_cfg,extra_args,match", [
    ("follow_trajectory = 1", ("--mode", "scan"), "loop mode only"),
])
def test_uncovered_branches_raise(dataset, tmp_path, extra_cfg, extra_args,
                                  match):
    """A branch the port refuses raises NotImplementedError, whatever else
    the run asks for, and nothing else runs in its place: follow_trajectory
    in scan mode (JAX's scan mode runs its one particle without reading
    traj.txt, a condition on the reference side that the port does not
    copy)."""
    _, d = dataset
    cfg = tmp_path / "x.cfg"
    cfg.write_text((d / "tiny.cfg").read_text() + "\n" + extra_cfg + "\n")
    (tmp_path / "traj.txt").write_text(
        "% traj\n" + "\n".join(_traj_rows(T)) + "\n")
    args = _args(d, tmp_path / "out", "--data-dir", str(tmp_path),
                 *extra_args)
    args[0] = str(cfg)
    with pytest.raises(NotImplementedError, match=match):
        runner.main(args)
    assert not (tmp_path / "out" / "loopTime.log").exists()


def test_follow_trajectory_pins_one_particle(dataset, tmp_path):
    """follow_trajectory = 1 in loop mode pins a single particle to
    traj.txt (tests/test_round2.py::test_follow_trajectory_mode on the
    port's runner): one particle per log, the logged pose the trajectory's
    at every step."""
    _, d = dataset
    cfg = tmp_path / "ft.cfg"
    cfg.write_text((d / "tiny.cfg").read_text()
                   + "\nfollow_trajectory = 1\nn_steps = 6\n")
    (tmp_path / "traj.txt").write_text(
        "% traj\n" + "\n".join(_traj_rows(6)) + "\n")
    out = tmp_path / "out"
    args = _args(d, out, "--data-dir", str(tmp_path))
    args[0] = str(cfg)
    runner.main(args)
    for t, lg in enumerate(_logs(out, 6)):
        assert lg["poses"].shape[0] == 1
        assert abs(lg["pose"][0] - 0.5 * t) < 1e-4, (t, lg["pose"])
        assert abs(lg["pose"][1] - 0.25 * t) < 1e-4


ISLAND_T = 12


def _island_run(d, tmp_path, name, extra_cfg, *extra):
    cfg = tmp_path / f"{name}.cfg"
    cfg.write_text((d / "tiny.cfg").read_text()
                   + f"\nn_steps = {ISLAND_T}\n{extra_cfg}\n")
    out = tmp_path / name
    args = _args(d, out, "--seed", "2", *extra)
    args[0] = str(cfg)
    res = runner.main(args)
    with open(out / "metrics.jsonl") as f:
        metrics = [json.loads(line) for line in f]
    assert [m["t"] for m in metrics] == list(range(ISLAND_T))
    assert len((out / "loopTime.log").read_text().split()) == ISLAND_T
    assert all(np.isfinite(m["neff"]) for m in metrics)
    return res, out, metrics


def test_islands_loop_mat_export(dataset, tmp_path, capsys):
    """--islands 2 with --mat-export in loop mode: JAX's island loop
    contract (the island-mode line; logs of every particle's local
    log-weight, normalised within each island; neff the island nEff in
    (0, 1]; resampled whether the butterfly ran) and a particlesXXXXX.mat
    of all 8 particles every step."""
    from phdslam_tpu_torch.io.matdump import read_particles_mat
    _, d = dataset
    _, out, metrics = _island_run(d, tmp_path, "isl2", "", "--islands", "2",
                                  "--mat-export")
    assert "island mode: 2 islands x 4 particles" in capsys.readouterr().out
    assert all(0.0 < m["neff"] <= 1.0 + 1e-6 for m in metrics)
    assert all(isinstance(m["resampled"], bool) for m in metrics)
    for t, lg in enumerate(_logs(out, ISLAND_T)):
        assert lg["weights"].shape == (8,) and lg["poses"].shape == (8, 6)
        assert np.isfinite(lg["pose"]).all()
        if t > 0:
            # local weights: each island's sum to 1
            np.testing.assert_allclose(
                np.exp(lg["weights"].reshape(2, 4)).sum(1), 1.0, atol=1e-3)
        m = read_particles_mat(str(out / f"particles{t:05d}.mat"))
        assert m["states"].shape == (6, 8)
        np.testing.assert_allclose(m["states"].T, lg["poses"], rtol=1e-5,
                                   atol=1e-5)


def test_islands_loop_eap_map(dataset, tmp_path):
    """map_estimate = 3 with --islands 4: the logs hold the EAP map of all
    particles (their local log-weights, as JAX's _write_step_log weighs
    them), the run tracks and maps."""
    _, d = dataset
    _, out, metrics = _island_run(d, tmp_path, "eap", "map_estimate = 3",
                                  "--islands", "4")
    lg = _logs(out, ISLAND_T)[-1]
    assert lg["static"].shape[0] > 0 and lg["static"][:, 0].sum() > 0.5
    assert max(m["card"] for m in metrics) > 0


def test_islands_scan_mode_log_contract(dataset, tmp_path):
    """--islands 4 in scan mode with --truth, tests/test_round2.py::
    test_island_scan_mode_writes_logs's assertions: a state_estimate log
    per step, all 8 particles with global log-weights (island + local)
    summing to 1 within 1e-3, a finite pose, ospa, exchanged and the
    island neff in every metrics line. The loop mode on the same seed
    draws the same numbers: the same expected pose every step."""
    sc, d = dataset
    truth = tmp_path / "truth.txt"
    np.savetxt(truth, sc.landmarks)
    res, out, metrics = _island_run(d, tmp_path, "scan", "", "--islands",
                                    "4", "--mode", "scan", "--truth",
                                    str(truth))
    est = sorted(p for p in os.listdir(out) if p.startswith("state_est"))
    assert len(est) == ISLAND_T
    for lg in _logs(out, ISLAND_T):
        assert lg["pose"].shape == (6,) and np.isfinite(lg["pose"]).all()
        assert lg["weights"].shape == (8,)
        assert abs(np.exp(lg["weights"]).sum() - 1.0) < 1e-3
    assert all("ospa" in m and isinstance(m["exchanged"], bool)
               and 0.0 < m["neff"] <= 1.0 + 1e-6 for m in metrics)
    np.testing.assert_allclose(
        torch.logsumexp(res["aux"].island_logw, -1).numpy(), 0.0, atol=1e-5)
    _, loop_out, _ = _island_run(d, tmp_path, "loop", "", "--islands", "4")
    for a, b in zip(_logs(out, ISLAND_T), _logs(loop_out, ISLAND_T)):
        np.testing.assert_array_equal(a["pose"], b["pose"])


def test_islands_resume(dataset, tmp_path):
    """--resume in island mode restores the state and the generator and
    starts the island weights uniform again (a checkpoint holds none, as in
    JAX's runner): with no exchange in either run, the resumed steps'
    particles and local weights equal the straight run's."""
    _, d = dataset
    _, out, metrics = _island_run(d, tmp_path, "straight", "", "--islands",
                                  "2", "--checkpoint-every", "5")
    resumed = tmp_path / "resumed"
    (resumed / "checkpoints").mkdir(parents=True)
    ck = "ckpt_000005.npz"
    (resumed / "checkpoints" / ck).write_bytes(
        (out / "checkpoints" / ck).read_bytes())
    args = _args(d, resumed, "--seed", "2", "--islands", "2", "--resume")
    args[0] = str(tmp_path / "straight.cfg")
    runner.main(args)
    with open(resumed / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["t"] for r in rows] == list(range(6, ISLAND_T))
    assert not any(m["resampled"] for m in metrics + rows)
    for t in range(6, ISLAND_T):
        a, b = (read_state_estimate_log(str(o / f"state_estimate{t:05d}.log"))
                for o in (out, resumed))
        np.testing.assert_array_equal(a["poses"], b["poses"])
        np.testing.assert_array_equal(a["weights"], b["weights"])


def test_islands_cphd_loop(dataset, tmp_path):
    """CPHD (filter_type = 1) in island mode, loop
    (tests/test_cli.py::test_cli_islands_cphd): births from the previous
    measurements through the island step, a metrics line a step with a
    finite neff, every cardinality line a log-pmf."""
    _, d = dataset
    _, out, _ = _island_run(d, tmp_path, "cphd",
                            "filter_type = 1\nmax_cardinality = 31",
                            "--islands", "4")
    for lg in _logs(out, ISLAND_T):
        assert lg["cardinality"].shape == (32,)
        assert abs(np.log(np.exp(lg["cardinality"]).sum())) < 1e-3


RESUME_T, RESUME_EVERY, RESUME_FROM = 20, 5, 10


@pytest.mark.parametrize("base,extra_cfg,extra_args", [
    pytest.param("cfg/ackerman_synth.cfg", "", (), id="static"),
    pytest.param("cfg/fastslam_synth.cfg",
                 "std_range = 0.25\nclutter_rate = 2.0", (), id="fastslam"),
    pytest.param("cfg/ackerman_synth.cfg", "save_prediction = 1", (),
                 id="save_prediction"),
    pytest.param("cfg/ackerman_synth.cfg", "", ("--truth", "truth.txt"),
                 id="truth"),
    pytest.param("cfg/ackerman_synth.cfg", "filter_type = 1", (),
                 id="cphd_z_prev"),
    pytest.param("cfg/mixed_synth.cfg", "", (), id="mixed"),
    pytest.param("cfg/mixed_synth.cfg", "birth_velocity_init = 1", (),
                 id="mixed_birth_velocity_z_prev"),
])
def test_checkpoint_resume(dataset, tmp_path, monkeypatch, base, extra_cfg,
                           extra_args):
    """--checkpoint-every K writes checkpoints/ckpt_<t>.npz after the steps
    t > 0 with t % K == 0 (the last three kept); a fresh out-dir holding
    only the step-10 checkpoint, run with --resume, writes the steps after
    it: the same state_estimate logs, byte for byte, as the straight run,
    and the same .mat prediction files and ospa columns. JAX's runner does
    not restore the previous step's measurements, and neither does the
    port: the first resumed step runs with z_prev None, which under CPHD
    skips that step's births and under the mixed model's
    birth_velocity_init gives its dynamic births the zero-velocity prior
    (so those two cases hold that step to differing, and every later step
    to finite weights and, under CPHD, normalised cardinality lines; the
    others, the mixed model without it included, are compared byte for
    byte)."""
    from phdslam_tpu_torch.io.matdump import read_particles_mat
    sc, d = dataset
    np.savetxt(tmp_path / "truth.txt", sc.landmarks)
    cfg = tmp_path / "r.cfg"
    cfg.write_text(open(base).read() + TINY + f"n_steps = {RESUME_T}\n"
                   + extra_cfg + "\n")
    extra = [str(tmp_path / a) if a == "truth.txt" else a
             for a in extra_args]
    z_prevs = {}
    step = runner.slam_step

    def recording_step(*a, **kw):
        z_prevs[name].append(kw["z_prev"])
        return step(*a, **kw)

    monkeypatch.setattr(runner, "slam_step", recording_step)
    outs = {}
    for name in ("straight", "resumed"):
        out = outs[name] = tmp_path / name
        if name == "resumed":
            (out / "checkpoints").mkdir(parents=True)
            ck = f"ckpt_{RESUME_FROM:06d}.npz"
            (out / "checkpoints" / ck).write_bytes(
                (outs["straight"] / "checkpoints" / ck).read_bytes())
            flags = ("--resume",)
        else:
            flags = ("--checkpoint-every", str(RESUME_EVERY))
        z_prevs[name] = []
        args = _args(d, out, "--seed", "6", "--data-dir", str(d), *flags,
                     *extra)
        args[0] = str(cfg)
        runner.main(args)
    # z_prev is None at the straight run's step 0 and at the resumed run's
    # first step, and nowhere else
    for name, n in (("straight", RESUME_T),
                    ("resumed", RESUME_T - RESUME_FROM - 1)):
        assert len(z_prevs[name]) == n
        assert [z is None for z in z_prevs[name]] == [True] + [False] * (
            n - 1)
    assert sorted(os.listdir(outs["straight"] / "checkpoints")) == [
        f"ckpt_{t:06d}.npz" for t in (5, 10, 15)]
    resumed = range(RESUME_FROM + 1, RESUME_T)
    straight_logs = _files(outs["straight"], "state_estimate")
    resumed_logs = _files(outs["resumed"], "state_estimate")
    assert sorted(resumed_logs) == [f"state_estimate{t:05d}.log"
                                    for t in resumed]
    with open(outs["resumed"] / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["t"] for r in rows] == list(resumed)
    if "filter_type = 1" in extra_cfg or "birth_velocity_init" in extra_cfg:
        # the first resumed step has no births (CPHD), or no informed
        # birth velocities (mixed), from step 10's measurements
        first = f"state_estimate{RESUME_FROM + 1:05d}.log"
        assert resumed_logs[first] != straight_logs[first]
        for t in resumed:
            lg = read_state_estimate_log(
                str(outs["resumed"] / f"state_estimate{t:05d}.log"))
            assert np.isfinite(lg["weights"]).all()
            assert abs(np.exp(lg["weights"]).sum() - 1.0) < 1e-3
            if "filter_type = 1" in extra_cfg:
                assert abs(np.log(np.exp(lg["cardinality"]).sum())) < 1e-3
        return
    assert resumed_logs == {k: v for k, v in straight_logs.items()
                            if k in resumed_logs}
    if "--truth" in extra_args:
        with open(outs["straight"] / "metrics.jsonl") as f:
            ref = [json.loads(line)["ospa"] for line in f][RESUME_FROM + 1:]
        assert [r["ospa"] for r in rows] == ref
    if "save_prediction" in extra_cfg:
        for t in resumed:
            name = f"particles_predict{t:05d}.mat"
            a = read_particles_mat(str(outs["straight"] / name))
            b = read_particles_mat(str(outs["resumed"] / name))
            np.testing.assert_array_equal(a["states"], b["states"])
            np.testing.assert_array_equal(a["weights"], b["weights"])


def _logs(out, n):
    return [read_state_estimate_log(str(out / f"state_estimate{t:05d}.log"))
            for t in range(n)]


def _files(out, prefix):
    return {p: (out / p).read_bytes() for p in sorted(os.listdir(out))
            if p.startswith(prefix)}


LOOP_SCAN_CASES = {
    "static": ("cfg/ackerman_synth.cfg", ""),
    "cphd": ("cfg/ackerman_synth.cfg", "filter_type = 1\n"
             "max_cardinality = 31"),
    "mixed": ("cfg/mixed_synth.cfg", ""),
    "fastslam": ("cfg/fastslam_synth.cfg",
                 "std_range = 0.25\nclutter_rate = 2.0"),
    "disparity": ("cfg/disparity_synth.cfg", ""),
}
DISP_T = 12
DISP_TINY = """
n_particles = 4
max_features = 8
particles_per_feature = 8
max_measurements = 8
"""


@pytest.fixture(scope="module")
def disparity_dataset(tmp_path_factory):
    sc = simdata.make_disparity_scenario(np.random.default_rng(3),
                                         n_landmarks=8, n_steps=DISP_T)
    meas = simdata.generate_disparity_run(np.random.default_rng(4), sc)
    assert all(len(z) for z in meas)
    d = tmp_path_factory.mktemp("disprun")
    simdata.write_disparity_files(str(d), sc, meas)
    return d


def _metrics(out):
    with open(out / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("kind", list(LOOP_SCAN_CASES))
def test_runner_loop_and_scan_write_the_same_logs(dataset, disparity_dataset,
                                                  tmp_path, kind):
    """Each filter's shipped cfg at small widths through both modes: the
    same draws from the same generator, so every state_estimate log is the
    same file, byte for byte, and every metrics line the same apart from
    its ms. Step 0 of a scan gets an empty previous set where the loop
    passes none: no CPHD births either way. FastSLAM also keeps its log
    contract: the map line holding the MAP particle's integer counters."""
    base, extra = LOOP_SCAN_CASES[kind]
    sc, d = dataset
    n = T
    if kind == "disparity":
        d, n = disparity_dataset, DISP_T
    cfg = tmp_path / f"{kind}.cfg"
    cfg.write_text(open(base).read()
                   + (DISP_TINY if kind == "disparity" else TINY)
                   + extra + "\n")
    outs = {}
    for mode in ("loop", "scan"):
        out = outs[mode] = tmp_path / mode
        if kind == "disparity":
            args = [str(cfg), "disparity", "--data-dir", str(d),
                    "--out-dir", str(out), "--device", "cpu"]
        else:
            args = _args(d, out, "--data-dir", str(d))
            args[0] = str(cfg)
        runner.main(args + ["--mode", mode, "--seed", "4"])
        assert [m["t"] for m in _metrics(out)] == list(range(n))
        assert len((out / "loopTime.log").read_text().split()) == n
    logs = _files(outs["loop"], "state_estimate")
    assert sorted(logs) == [f"state_estimate{t:05d}.log" for t in range(n)]
    assert logs == _files(outs["scan"], "state_estimate")
    drop_ms = lambda rows: [{k: v for k, v in r.items() if k != "ms"}
                            for r in rows]
    assert drop_ms(_metrics(outs["loop"])) == drop_ms(_metrics(outs["scan"]))
    if kind == "fastslam":
        lgs = _logs(outs["scan"], T)
        w = np.concatenate([lg["static"][:, 0] for lg in lgs])
        assert len(w) and (w == np.round(w)).all() and w.min() >= 1
        assert max(m["card"] for m in _metrics(outs["scan"])) >= 5
        errs = np.array([np.linalg.norm(lg["pose"][:2] - sc.traj[t, :2])
                         for t, lg in enumerate(lgs)])
        assert np.isfinite(errs).all()


def test_runner_truth_ospa_column(dataset, tmp_path):
    """--truth adds [ospa, loc, card] to every metrics line, in loop and
    scan mode alike; each is JAX's _ospa_from_map of that step's logged
    MAP map (to the log's six digits); the port's _ospa_from_map equals
    JAX's on the same maps."""
    from phdslam_tpu import runner as JR
    sc, d = dataset
    truth = tmp_path / "truth.txt"
    np.savetxt(truth, sc.landmarks)
    rows = {}
    for mode in ("loop", "scan"):
        out = tmp_path / mode
        runner.main(_args(d, out, "--mode", mode, "--seed", "3", "--truth",
                          str(truth), "--data-dir", str(d)))
        with open(out / "metrics.jsonl") as f:
            rows[mode] = [json.loads(line)["ospa"] for line in f]
    assert rows["loop"] == rows["scan"]
    tm = JR.load_truth_maps(str(truth))
    tm_port = runner.load_truth_maps(str(truth))
    np.testing.assert_array_equal(tm(3), tm_port(3))
    for t, lg in enumerate(_logs(tmp_path / "loop", T)):
        w, mx, my = lg["static"][:, 0], lg["static"][:, 1], lg["static"][:, 2]
        np.testing.assert_allclose(rows["loop"][t],
                                   JR._ospa_from_map(w, mx, my, tm, t),
                                   rtol=0, atol=2e-4)
        np.testing.assert_allclose(runner._ospa_from_map(w, mx, my, tm, t),
                                   JR._ospa_from_map(w, mx, my, tm, t),
                                   rtol=0, atol=1e-9)
    assert rows["loop"][-1][0] < rows["loop"][0][0]


def test_runner_eap_map_and_mat_export(dataset, tmp_path):
    """map_estimate = 3 with --mat-export: every log's map is the EAP map,
    each particlesXXXXX.mat holds every particle's map with the MAP and EAP
    estimates, and JAX's eap_map_np of the written particles gives the
    written EAP map."""
    from phdslam_tpu.filter.estimate import eap_map_np as j_eap

    from phdslam_tpu_torch.io.matdump import read_particles_mat
    _, d = dataset
    cfg = tmp_path / "eap.cfg"
    cfg.write_text((d / "tiny.cfg").read_text() + "\nmap_estimate = 3\n"
                   "n_steps = 12\n")
    out = tmp_path / "out"
    args = _args(d, out, "--mat-export", "--data-dir", str(d))
    args[0] = str(cfg)
    runner.main(args)
    for t, lg in enumerate(_logs(out, 12)):
        m = read_particles_mat(str(out / f"particles{t:05d}.mat"))
        assert m["states"].shape == (6, 8) and m["weights"].shape == (8,)
        exp = m["exp_map_static"]
        w_exp = exp["weights"][0]
        np.testing.assert_allclose(lg["static"][:, 0], w_exp, rtol=1e-5)
        np.testing.assert_allclose(lg["static"][:, 1:3], exp["means"][0].T,
                                   rtol=1e-5, atol=1e-5)
        P = m["states"].shape[1]
        F = max(len(x) for x in m["maps_static"]["weights"])
        w = np.zeros((P, F))
        mean = np.zeros((P, F, 2))
        cov = np.tile(np.eye(2), (P, F, 1, 1))
        for p in range(P):
            n = len(m["maps_static"]["weights"][p])
            w[p, :n] = m["maps_static"]["weights"][p]
            mean[p, :n] = m["maps_static"]["means"][p].T
            cov[p, :n] = np.moveaxis(m["maps_static"]["covs"][p], -1, 0)
        ref = j_eap(m["weights"], w, mean, cov, 5.0)
        np.testing.assert_allclose(w_exp, ref[0], rtol=1e-6)
        np.testing.assert_allclose(exp["means"][0].T, ref[1], rtol=1e-6,
                                   atol=1e-9)
        mx = m["max_map_static"]["weights"][0]
        assert len(mx) == (m["maps_static"]["weights"][
            int(np.argmax(m["weights"]))] > 0).sum()
    assert len(w_exp) > 0


def test_runner_prediction_outputs_leave_the_run_unchanged(dataset,
                                                          tmp_path):
    """save_prediction writes particles_predictXXXXX.mat and --predict-time
    writes predicttime.log; the run's logs stay byte for byte those of a
    run without them, and each predicted particle set is the one the step
    updated (the step's particles are the predicted ones gathered at its
    resample indices)."""
    from phdslam_tpu_torch.io.matdump import read_particles_mat
    _, d = dataset
    base = (d / "tiny.cfg").read_text() + "\nn_steps = 10\n"
    (tmp_path / "a.cfg").write_text(base)
    (tmp_path / "b.cfg").write_text(base + "save_prediction = 1\n")
    outs = []
    for name, extra in (("a", ()), ("b", ("--predict-time",))):
        out = tmp_path / f"out_{name}"
        args = _args(d, out, "--data-dir", str(d), "--seed", "5", *extra)
        args[0] = str(tmp_path / f"{name}.cfg")
        runner.main(args)
        outs.append(out)
    assert _files(outs[0], "state_estimate") == \
        _files(outs[1], "state_estimate")
    assert len((outs[1] / "predicttime.log").read_text().split()) == 9
    assert not (outs[0] / "predicttime.log").exists()
    for t, lg in enumerate(_logs(outs[1], 10)):
        pred = read_particles_mat(str(outs[1] /
                                      f"particles_predict{t:05d}.mat"))
        np.testing.assert_allclose(
            pred["states"].T[lg["resample_idx"]], lg["poses"], rtol=1e-5,
            atol=1e-5)


def test_runner_step100_fixture_profile_and_player(tmp_path):
    """A 102-step run writes state100.pkl (numpy: the state before step
    100 and its measurements); `synth profile` replays it through two
    steps; --player writes player.html."""
    import pickle
    sc = simdata.make_scenario(np.random.default_rng(11), n_landmarks=40,
                               n_steps=102, clutter_rate=4.0)
    controls, meas = simdata.generate_run(np.random.default_rng(24), sc,
                                          control_noise=(0.05, 0.005))
    assert all(len(z) for z in meas)
    simdata.write_run_files(str(tmp_path), controls, meas)
    cfg = tmp_path / "p.cfg"
    cfg.write_text(open("cfg/ackerman_synth.cfg").read()
                   + TINY.replace("n_particles = 8", "n_particles = 4"))
    out = tmp_path / "out"
    args = [str(cfg), "synth", "--data-dir", str(tmp_path), "--out-dir",
            str(out), "--device", "cpu", "--player"]
    runner.main(args)
    assert (out / "player.html").read_text().startswith("<!DOCTYPE html>")
    with open(out / "state100.pkl", "rb") as f:
        d = pickle.load(f)
    assert d["state"]["pose"].shape == (4, 6)
    assert d["state"]["map_static"]["w"].shape == (4, 16)
    assert d["z"]["rb"].shape == (8, 2) and d["z"]["valid"].dtype == bool
    assert isinstance(d["state"]["log_weights"], np.ndarray)
    res = runner.main([str(cfg), "synth", "profile", "--out-dir", str(out),
                       "--device", "cpu"])
    assert len(res["ms"]) == 2 and min(res["ms"]) > 0


def test_schedule_lockstep_and_interleave():
    lock = runner.schedule_inputs(3, None, None)
    assert [(s["z"], s["c"]) for s in lock] == [(0, None), (1, 0), (2, 1)]
    inter = runner.schedule_inputs(
        5, np.array([0.5, 1.0, 3.0]), np.array([1.0, 2.0, 3.0]))
    assert [(s["z"], s["c"], s["dt"]) for s in inter] == [
        (0, None, 1.0), (1, 0, 0.0), (None, 1, 1.0), (2, 2, 1.0)]

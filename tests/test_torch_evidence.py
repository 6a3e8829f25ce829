"""The port's evidence entry points (``phdslam_tpu_torch/evidence/``)
against the JAX package's evidence scripts (``scripts/*.py``) on the same
filter outputs.

Each JAX script is loaded from ``scripts/`` with ``importlib`` and run in
``tmp_path`` (the cfgs and the shipped disparity data copied there) with its
filter calls replaced by stubs that return canned outputs made from a
numpy seed: ``run_batch``, ``run_scan``, ``slam_step``,
``run_disparity_scan``, the CPU references' ``run`` and ``ospa_jax``. The
port's entry point runs with the same stubs in place of its own filter
calls, so both compute their statistics from the same outputs, the n-th
call of a stub returning the same values on both sides. A fake clock that
advances one second a reading stands in for both sides' clocks. Then:

- the JSON entries are equal (floats to 1e-9 relative; the port's entries
  add ``device``, ``power_limit_w`` and, for ``vmap``, each path's
  late-half pose error);
- every call's config equals the port's, field by field, and so do the
  data handed to the filter (scenario, controls, measurement sets, labels,
  the filter's seed against JAX's ``PRNGKey``).

No JAX compile is needed: the stubs stand where the filter would run."""

import dataclasses
import importlib.util
import json
import os
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from phdslam_tpu_torch.eval.batch import RunResult
from phdslam_tpu_torch.filter.step import LogAux

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: keys the port's entries add to the script's
PORT_ONLY = {"device", "power_limit_w", "pose_late_mean_vmapped",
             "pose_late_mean_sequential"}


class FakeClock:
    """time.time and time.perf_counter advancing 1 s a reading."""

    def __init__(self):
        self.t = 0.0

    def time(self):
        self.t += 1.0
        return self.t

    perf_counter = time


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    shutil.copytree(os.path.join(REPO, "cfg"), tmp_path / "cfg")
    shutil.copytree(os.path.join(REPO, "data", "disparity_synth"),
                    tmp_path / "data" / "disparity_synth")
    (tmp_path / "results").mkdir()
    monkeypatch.chdir(tmp_path)
    return tmp_path


def load_script(name, argv, monkeypatch):
    """scripts/<name>.py as a fresh module, sys.argv set for its flags and
    its clock faked."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}_{abs(hash(tuple(argv)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "time", FakeClock(), raising=False)
    return mod


def port_module(name, monkeypatch):
    mod = importlib.import_module(f"phdslam_tpu_torch.evidence.{name}")
    monkeypatch.setattr(mod, "time", FakeClock(), raising=False)
    return mod


def port_argv(tmp_path, *argv):
    return [*argv, "--device", "cpu", "--out", str(tmp_path / "port.json")]


def assert_same(jax_v, port_v, path=""):
    """The port's value equals JAX's: dicts key by key (the port may add
    PORT_ONLY keys), floats to 1e-9 relative."""
    if isinstance(jax_v, dict):
        assert isinstance(port_v, dict), path
        assert set(jax_v) <= set(port_v), (path, set(jax_v) - set(port_v))
        assert set(port_v) - set(jax_v) <= PORT_ONLY, path
        for k in jax_v:
            assert_same(jax_v[k], port_v[k], f"{path}.{k}")
    elif isinstance(jax_v, list):
        assert len(jax_v) == len(port_v), path
        for i, (a, b) in enumerate(zip(jax_v, port_v)):
            assert_same(a, b, f"{path}.{i}")
    elif isinstance(jax_v, float) and not isinstance(port_v, bool):
        assert port_v == pytest.approx(jax_v, rel=1e-9, abs=0, nan_ok=True), \
            path
    else:
        assert jax_v == port_v, path


def read(path):
    with open(path) as f:
        return json.load(f)


def assert_same_config(jax_cfg, port_cfg):
    assert dataclasses.asdict(jax_cfg) == dataclasses.asdict(port_cfg)


class Stub:
    """A filter call replaced: records its calls and returns the n-th
    canned output."""

    def __init__(self, make, record):
        self.make, self.record, self.calls = make, record, []

    def __call__(self, *a, **kw):
        self.calls.append(self.record(*a, **kw))
        return self.make(len(self.calls) - 1, *a, **kw)


# ------------------------------------------------------------- round3 --

def canned_results(i, sc, n_runs, every):
    """Canned RunResults of the i-th run_batch call."""
    rng = np.random.default_rng(10_000 + i)
    t_len = sc.traj.shape[0]
    out = []
    for _ in range(n_runs):
        ospa = np.full((t_len, 3), np.nan)
        card_est = card_true = None
        if every:
            steps = sorted(set(range(0, t_len, every)) | {t_len - 1})
            ospa[steps] = rng.uniform(0.0, 5.0, (len(steps), 3))
            card_est = rng.uniform(0.0, 60.0, t_len)
            card_true = np.sort(rng.integers(0, 64, t_len)).astype(float)
        out.append(RunResult(
            poses=rng.normal(size=(t_len, 6)),
            pose_err=rng.gamma(2.0, 0.4, t_len), ospa=ospa,
            neff=rng.uniform(size=t_len), ms_per_step=1.0,
            card_est=card_est, card_true=card_true))
    return out


def batch_stub():
    def record(cfg, sc, n_runs, **kw):
        return dict(cfg=cfg, traj=sc.traj.copy(), n_runs=n_runs,
                    control_noise=tuple(kw.get("control_noise", (0.2, 0.01))),
                    vmapped=kw.get("vmapped", False),
                    collect_maps_every=kw.get("collect_maps_every", 1))
    return Stub(lambda i, cfg, sc, n_runs, **kw: canned_results(
        i, sc, n_runs, kw.get("collect_maps_every", 1)), record)


def canned_cpu_run(i, cfg, controls, meas, seed=0, callback=None,
                   label_sets=None):
    """Canned poses of the i-th CPU reference run; the callback gets
    canned particles each step."""
    rng = np.random.default_rng(20_000 + i)
    t_len = len(meas)
    for t in range(t_len if callback else 0):
        callback(t, SimpleNamespace(particles=[SimpleNamespace(
            log_weight=float(rng.normal()), w=rng.uniform(size=7))
            for _ in range(4)]))
    return rng.normal(size=(t_len, 6))


def cpu_stub():
    def record(cfg, controls, meas, seed=0, callback=None, label_sets=None):
        return dict(cfg=cfg, controls=np.asarray(controls).copy(),
                    meas=[np.asarray(z).copy() for z in meas], seed=seed)
    return Stub(canned_cpu_run, record)


def assert_same_calls(jax_stub, port_stub, keys):
    assert len(jax_stub.calls) == len(port_stub.calls)
    for a, b in zip(jax_stub.calls, port_stub.calls):
        assert_same_config(a["cfg"], b["cfg"])
        for k in keys:
            if k == "meas":
                assert len(a[k]) == len(b[k])
                for za, zb in zip(a[k], b[k]):
                    np.testing.assert_array_equal(za, zb)
            elif isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


ROUND3 = {"vmap": "vmap", "merge": "merge_modes", "variants": "variants",
          "parity": "parity_config2", "cphd_cpu": "cphd_cpu_oracle"}


@pytest.mark.parametrize("phase", list(ROUND3))
def test_round3_phase_matches_jax(phase, workdir, monkeypatch):
    """Each phase of scripts/round3_evidence.py at its full sizes: the
    entry and every run_batch and CPU reference call equal the port's."""
    import phdslam_tpu.eval.batch as JB
    import phdslam_tpu.eval.plots as JP
    import phdslam_tpu.reference_cpu as JR

    import phdslam_tpu_torch.eval.batch as TB
    import phdslam_tpu_torch.reference_cpu as TR
    jb, jr, tb, tr = batch_stub(), cpu_stub(), batch_stub(), cpu_stub()
    monkeypatch.setattr(JB, "run_batch", jb)
    monkeypatch.setattr(JR, "run", jr)
    monkeypatch.setattr(JP, "plot_error_curves", lambda *a, **k: None)
    monkeypatch.setattr(TB, "run_batch", tb)
    monkeypatch.setattr(TR, "run", tr)

    script = load_script("round3_evidence", [phase], monkeypatch)
    script.PHASES[phase]()
    port = port_module("round3", monkeypatch)
    port.main(port_argv(workdir, phase))

    key = ROUND3[phase]
    assert_same(read("results/round3_evidence.json")[key],
                read(workdir / "port.json")[key])
    assert jb.calls and (jr.calls or phase in ("vmap", "merge", "variants"))
    assert_same_calls(jb, tb, ("traj", "n_runs", "control_noise", "vmapped",
                               "collect_maps_every"))
    assert_same_calls(jr, tr, ("controls", "meas", "seed"))


# -------------------------------------------------------------- mixed --

def canned_scan(i, t_len, traj=None, n_particles=8, n_feat=12,
                n_card=1):
    """Canned run_scan outputs of the i-th call: (final's dynamic weights
    [P, Fd] and log-weights [P], expected poses [T, 6], the LogAux fields
    by name)."""
    rng = np.random.default_rng(30_000 + i)
    P, F = n_particles, n_feat
    base = np.zeros((t_len, 6)) if traj is None else np.pad(
        traj[:t_len], ((0, 0), (0, 3)))
    live = rng.uniform(size=(t_len, 1)) < 0.9       # some steps empty
    la = dict(
        map_w=rng.uniform(0.0, 1.0, (t_len, F)),
        map_mx=base[:, :1] + rng.uniform(-12, 12, (t_len, F)),
        map_my=base[:, 1:2] + rng.uniform(-12, 12, (t_len, F)),
        dyn_w=rng.uniform(0.0, 1.0, (t_len, F))
        * (rng.uniform(size=(t_len, F)) < 0.5) * live,
        dyn_mean=np.concatenate([rng.uniform(-20, 20, (t_len, 2, F)),
                                 rng.normal(0, 0.3, (t_len, 2, F))], 1),
        log_weights=rng.normal(size=(t_len, P)),
        poses=base[:, None, :] + rng.normal(0, 0.3, (t_len, P, 6)),
        cardinality=np.log(rng.dirichlet(np.ones(n_card), t_len)))
    final = dict(dyn_w=rng.uniform(size=(P, F)), log_weights=rng.normal(
        size=P))
    pose = base + rng.normal(0, 0.5, (t_len, 6))
    return final, pose, la


def jax_scan_view(final, pose, la):
    f = SimpleNamespace(map_dynamic=SimpleNamespace(w=final["dyn_w"]),
                        log_weights=final["log_weights"])
    return f, (SimpleNamespace(expected_pose=pose), SimpleNamespace(**la))


def port_scan_view(final, pose, la):
    t = torch.as_tensor
    f = SimpleNamespace(map_dynamic=SimpleNamespace(w=t(final["dyn_w"])),
                        log_weights=t(final["log_weights"]))
    fields = {k: t(la[k]) if k in la else torch.zeros(1)
              for k in LogAux._fields}
    return f, (SimpleNamespace(expected_pose=t(pose)), LogAux(**fields))


def scan_stubs(traj=None, **kw):
    """(JAX run_scan stub, port run_scan stub) on the same canned
    outputs."""
    def jax_make(i, state, key, ctrl, zs, dts, cfg, t_len, **k):
        return jax_scan_view(*canned_scan(i, t_len, traj, **kw))

    def jax_record(state, key, ctrl, zs, dts, cfg, t_len, **k):
        return dict(cfg=cfg, seed=int(np.asarray(key)[-1]),
                    ctrl=np.asarray(ctrl), rb=np.asarray(zs.rb),
                    label=np.asarray(zs.label), valid=np.asarray(zs.valid),
                    dts=np.asarray(dts), log=k.get("with_log_state"))

    def port_make(i, state, ctrl, zs, dts, cfg, **k):
        return port_scan_view(*canned_scan(i, len(zs), traj, **kw))

    def port_record(state, ctrl, zs, dts, cfg, **k):
        stack = lambda f: np.stack([getattr(z, f).numpy() for z in zs])
        return dict(cfg=cfg, seed=k["generator"].initial_seed(),
                    ctrl=np.asarray(ctrl), rb=stack("rb"),
                    label=stack("label"), valid=stack("valid"),
                    dts=np.asarray(dts), log=k.get("with_log_state"))
    return Stub(jax_make, jax_record), Stub(port_make, port_record)


SCAN_KEYS = ("seed", "ctrl", "rb", "label", "valid", "dts", "log")


@pytest.mark.parametrize("flags, key", [
    ((), "mixed"),
    (("--labeled",), "mixed_labeled"),
    (("--informed", "--set", "covVxBirth=0.25"),
     "mixed_informed_covVxBirth0.25"),
])
def test_mixed_matches_jax(flags, key, workdir, monkeypatch):
    """scripts/mixed_evidence.py at its full sizes (10 runs x 150 steps,
    the paused-dwell leg, the CPU leg where it runs): the entry, the
    configs and the measurement sets (labels under --labeled) equal the
    port's."""
    import phdslam_tpu.filter.step as JS
    import phdslam_tpu.reference_cpu as JR
    import phdslam_tpu.utils as JU

    import phdslam_tpu_torch.filter.step as TS
    import phdslam_tpu_torch.reference_cpu as TR
    js, ts = scan_stubs()
    jr, tr = cpu_stub(), cpu_stub()
    monkeypatch.setattr(JS, "run_scan", js)
    monkeypatch.setattr(JR, "run", jr)
    monkeypatch.setattr(JU, "ensure_backend", lambda: None)
    monkeypatch.setattr(TS, "run_scan", ts)
    monkeypatch.setattr(TR, "run", tr)

    script = load_script("mixed_evidence", list(flags), monkeypatch)
    script.main()
    port = port_module("mixed", monkeypatch)
    port.main(port_argv(workdir, *flags))

    assert_same(read("results/round3_evidence.json")[key],
                read(workdir / "port.json")[key])
    assert len(js.calls) == 15
    assert_same_calls(js, ts, SCAN_KEYS)
    assert_same_calls(jr, tr, ("controls", "meas", "seed"))
    assert bool(js.calls[0]["label"].any()) == ("--labeled" in flags)


# ----------------------------------------------------------- fastslam --

def step_stubs(traj):
    """(JAX slam_step stub, port slam_step stub): canned expected poses
    near the truth."""
    def pose(i):
        rng = np.random.default_rng(40_000 + i)
        return np.pad(traj[i], (0, 3)) + rng.normal(0, 0.4, 6)

    def jax_make(i, state, key, u, z, dt, do_predict, cfg):
        return state, SimpleNamespace(expected_pose=pose(i))

    def jax_record(state, key, u, z, dt, do_predict, cfg):
        return dict(cfg=cfg, u=(float(u[0]), float(u[1])),
                    rb=np.asarray(z.rb), label=np.asarray(z.label),
                    valid=np.asarray(z.valid), dt=float(dt),
                    predict=bool(do_predict))

    def port_make(i, state, u, z, dt, do_predict, cfg, **k):
        return state, SimpleNamespace(expected_pose=torch.as_tensor(pose(i)))

    def port_record(state, u, z, dt, do_predict, cfg, **k):
        return dict(cfg=cfg, u=(float(u[0]), float(u[1])),
                    rb=z.rb.numpy(), label=z.label.numpy(),
                    valid=z.valid.numpy(), dt=float(dt),
                    predict=bool(do_predict), count=z.count,
                    seed=k["generator"].initial_seed())
    return Stub(jax_make, jax_record), Stub(port_make, port_record)


@pytest.mark.parametrize("cell", [(2.0, 0.25, 2), (20.0, 1.0, 0)])
def test_fastslam_cell_matches_jax(cell, workdir, monkeypatch):
    """A cell of scripts/fastslam_evidence.py (150 steps, 256 particles):
    the row, and every step's config, control, measurements and dt equal
    the port's; the port's generator is seeded 5 (JAX's PRNGKey(5))."""
    import phdslam_tpu.filter.step as JS
    import phdslam_tpu.utils as JU

    import phdslam_tpu_torch.filter.step as TS
    from phdslam_tpu_torch.simdata import make_scenario
    traj = make_scenario(np.random.default_rng(7), n_landmarks=80,
                         n_steps=150, clutter_rate=cell[0]).traj
    js, ts = step_stubs(traj)
    monkeypatch.setattr(JS, "slam_step", js)
    monkeypatch.setattr(JU, "ensure_backend", lambda: None)
    monkeypatch.setattr(TS, "slam_step", ts)

    script = load_script("fastslam_evidence", [], monkeypatch)
    row = script.run_cell(*cell)
    port = port_module("fastslam", monkeypatch)
    rows = port.main(port_argv(workdir, "--cell", *map(str, cell)))
    key = f"c{cell[0]:g}_s{cell[1]:g}_f{cell[2]}"
    assert_same(row, rows[key])
    assert_same(row, read(workdir / "port.json")["fastslam_grid"][key])
    assert len(js.calls) == len(ts.calls) == 150
    assert {c["seed"] for c in ts.calls} == {5}
    for a, b in zip(js.calls, ts.calls):
        assert_same_config(a["cfg"], b["cfg"])
        assert (a["u"], a["dt"], a["predict"]) == (b["u"], b["dt"],
                                                   b["predict"])
        for k in ("rb", "label", "valid"):
            np.testing.assert_array_equal(a[k], b[k])
        assert b["count"] == int(a["valid"].sum())


# --------------------------------------------------------- cphd_dwell --

def test_cphd_dwell_matches_jax(workdir, monkeypatch):
    """scripts/cphd_dwell.py: the entry (E[n], in-FOV mass and truth per
    step, the dwell statistics), the config and the run's data equal the
    port's."""
    import phdslam_tpu.filter.step as JS

    import phdslam_tpu_torch.filter.step as TS
    from phdslam_tpu_torch.simdata import make_scenario
    traj = make_scenario(np.random.default_rng(5), n_landmarks=40,
                         n_steps=110, pause=(40, 60)).traj
    js, ts = scan_stubs(traj, n_card=128)
    monkeypatch.setattr(JS, "run_scan", js)
    monkeypatch.setattr(TS, "run_scan", ts)

    script = load_script("cphd_dwell", [], monkeypatch)
    script.main()
    port = port_module("cphd_dwell", monkeypatch)
    port.main(port_argv(workdir))
    assert_same(read("results/cphd_dwell.json"),
                read(workdir / "port.json")["cphd_dwell"])
    assert_same_calls(js, ts, SCAN_KEYS)


# ----------------------------------------------------------- disparity --

def disparity_stubs(traj, landmarks):
    """(JAX run_disparity_scan stub, port stub): canned expected camera
    poses near the truth and MAP-particle maps near the landmarks."""
    def canned(i, t_len):
        rng = np.random.default_rng(50_000 + i)
        F = 40
        pose = traj[:t_len] + rng.normal(0, 0.1, (t_len, 12))
        w = rng.uniform(0.0, 1.5, (t_len, F)) \
            * (rng.uniform(size=(t_len, F)) < 0.8)
        idx = rng.integers(0, len(landmarks), (t_len, F))
        mean = landmarks[idx] + rng.normal(0, 0.3, (t_len, F, 3))
        return pose, w, mean, np.zeros((t_len, F, 3, 3))

    def jax_make(i, state, key, rb, valid, cfg, t_len, **k):
        pose, w, mean, cov = canned(i, t_len)
        return state, (SimpleNamespace(expected_pose=pose), None,
                       (w, mean, cov))

    def jax_record(state, key, rb, valid, cfg, t_len, **k):
        return dict(cfg=cfg, rb=np.asarray(rb), valid=np.asarray(valid),
                    log=k.get("with_map_log"))

    def port_make(i, state, zs, dt, cfg, **k):
        pose, w, mean, cov = (torch.as_tensor(a) for a in canned(i, len(zs)))
        return state, (SimpleNamespace(expected_pose=pose), None,
                       (w, mean, cov))

    def port_record(state, zs, dt, cfg, **k):
        return dict(cfg=cfg, seed=k["generator"].initial_seed(),
                    rb=np.stack([z.rb.numpy() for z in zs]),
                    valid=np.stack([z.valid.numpy() for z in zs]),
                    log=k.get("with_map_log"))
    return Stub(jax_make, jax_record), Stub(port_make, port_record)


@pytest.mark.parametrize("oracle", [False, True])
def test_disparity_matches_jax(oracle, workdir, monkeypatch):
    """scripts/disparity_evidence.py, main (10 runs x 100 steps) and
    --oracle (the shipped stream, the CPU reference at 16 particles): the
    entry, the configs and the measurement sets equal the port's."""
    import phdslam_tpu.filter.disparity as JD
    import phdslam_tpu.reference_cpu_disparity as JRD
    import phdslam_tpu.utils as JU

    import phdslam_tpu_torch.filter.disparity as TD
    import phdslam_tpu_torch.reference_cpu_disparity as TRD
    from phdslam_tpu_torch.simdata import make_disparity_scenario
    if oracle:
        traj = np.loadtxt(os.path.join(REPO, "data", "disparity_synth",
                                       "traj.txt"), comments="%")
        landmarks = np.loadtxt(os.path.join(
            REPO, "data", "disparity_synth", "landmarks.txt"),
            comments="%").reshape(-1, 3)
    else:
        sc = make_disparity_scenario(np.random.default_rng(7),
                                     n_landmarks=30, n_steps=100)
        traj, landmarks = sc.traj, sc.landmarks
    js, ts = disparity_stubs(traj, landmarks)

    def cpu_record(cfg, meas, seed=0, callback=None):
        return dict(cfg=cfg, meas=[np.asarray(z).copy() for z in meas],
                    seed=seed)

    def cpu_make(i, cfg, meas, seed=0, callback=None):
        """Canned camera poses; the callback gets canned particles."""
        rng = np.random.default_rng(20_000 + i)
        for t in range(len(meas)):
            callback(t, [SimpleNamespace(log_weight=float(rng.normal()),
                                         w=rng.uniform(size=7))
                         for _ in range(4)])
        return traj[:len(meas)] + rng.normal(0, 0.1, (len(meas), 12))
    jr, tr = Stub(cpu_make, cpu_record), Stub(cpu_make, cpu_record)
    monkeypatch.setattr(JD, "run_disparity_scan", js)
    monkeypatch.setattr(JRD, "run", jr)
    monkeypatch.setattr(JU, "ensure_backend", lambda: None)
    monkeypatch.setattr(TD, "run_disparity_scan", ts)
    monkeypatch.setattr(TRD, "run", tr)

    flags = ["--oracle"] if oracle else []
    script = load_script("disparity_evidence", flags, monkeypatch)
    (script.oracle_phase if oracle else script.main)()
    port = port_module("disparity", monkeypatch)
    port.main(port_argv(workdir, *flags))
    key = "disparity_cpu_oracle" if oracle else "disparity"
    assert_same(read("results/round3_evidence.json")[key],
                read(workdir / "port.json")[key])
    assert len(js.calls) == (1 if oracle else 10)
    assert_same_calls(js, ts, ("rb", "valid", "log"))
    # JAX's PRNGKey(run), split for the jitter: the port's generator
    # seeded run draws the jitter and then the run
    assert [c["seed"] for c in ts.calls] == ([1] if oracle
                                             else list(range(10)))
    assert_same_calls(jr, tr, ("meas", "seed"))


# -------------------------------------------------------- ospa_latency --

def test_ospa_latency_matches_jax(workdir, monkeypatch):
    """scripts/ospa_latency.py: the rows (the largest gap to ospa_np over
    the 8 pairs a size, the timing window's mean) equal the port's on the
    same canned OSPA values, computed from the same set pairs."""
    from phdslam_tpu_torch.ops import ospa as TO

    def canned(i, x, xv, y, yv, p, c):
        x, xv, y, yv = (np.asarray(a) for a in (x, xv, y, yv))
        exact = TO.ospa_np(x[xv], y[yv], p=p, c=c)[0]
        gap = np.random.default_rng(60_000 + i).normal(0.0, 1e-3)
        return exact + gap

    def record(x, xv, y, yv, p, c):
        return tuple(np.asarray(a).copy() for a in (x, xv, y, yv))

    jo = Stub(lambda i, *a, p, c: (np.float32(canned(i, *a, p, c)), 0, 0),
              lambda *a, p, c: record(*a, p, c))
    to = Stub(lambda i, *a, p, c: (torch.tensor(canned(i, *a, p, c),
                                                dtype=torch.float32), 0, 0),
              lambda *a, p, c: record(*a, p, c))
    monkeypatch.setattr(TO, "ospa_torch", to)
    script = load_script("ospa_latency", [], monkeypatch)
    monkeypatch.setattr(script, "ospa_jax", jo)
    monkeypatch.setattr(script, "ensure_backend", lambda: None)
    script.main()
    port = port_module("ospa_latency", monkeypatch)
    port.main(port_argv(workdir))
    jax_out = read("results/ospa_latency.json")
    port_out = read(workdir / "port.json")["ospa_latency"]
    assert_same(jax_out["rows"], port_out["rows"])
    assert port_out["backend"] == jax_out["backend"] == "cpu"
    assert len(jo.calls) == len(to.calls) == 3 * (8 + 20)
    for a, b in zip(jo.calls, to.calls):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)

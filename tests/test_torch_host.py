"""The port's own copies of the JAX package's host modules (``config.py``,
``simdata.py``, ``io/loaders.py``, ``io/logs.py``, ``ops/jcbb.py``,
``io/matdump.py``, ``ops/gm.py::reduce_mixture_np``,
``filter/estimate.py::eap_map_np``, ``ops/ospa.py::ospa_np``,
``eval/player.py::build_player`` and ``LogPlayer``, ``eval/plots.py``)
against the originals: the same cfg
fields, the same arrays from one seed, the same parsed files, the same log
bytes, the same associations, maps, metrics, .mat fields and HTML. Exact
comparisons where the copies run the same numpy code; the EAP map to rtol
1e-6 and OSPA to 1e-9, where the JAX package may run its optional native
reducer and assignment solver instead."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from phdslam_tpu import config as JC
from phdslam_tpu import simdata as JSD
from phdslam_tpu.io import loaders as JL
from phdslam_tpu.io import logs as JLG
from phdslam_tpu_torch import config as TC
from phdslam_tpu_torch import simdata as TSD
from phdslam_tpu_torch.io import loaders as TL
from phdslam_tpu_torch.io import logs as TLG

torch.set_num_threads(1)

CFGS = sorted(glob.glob("cfg/*.cfg"))


@pytest.mark.parametrize("path", CFGS, ids=[os.path.basename(p)
                                            for p in CFGS])
def test_load_config_matches_jax(path):
    ref = dataclasses.asdict(JC.load_config(path))
    got = dataclasses.asdict(TC.load_config(path))
    assert got == ref
    assert TC.load_config(path).replace(maxRange=5.0).clutterDensity == \
        JC.load_config(path).replace(maxRange=5.0).clutterDensity


def _assert_tree_equal(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["static", "mixed"])
def test_simdata_matches_jax(kind):
    """make_scenario, then generate_run or generate_mixed_run (with labels)
    from the same seeds."""
    def run(mod):
        sc = mod.make_scenario(np.random.default_rng(4), n_landmarks=10,
                               n_steps=15, clutter_rate=3.0)
        rng = np.random.default_rng(9)
        if kind == "static":
            out = mod.generate_run(rng, sc, control_noise=(0.1, 0.01))
        else:
            out = mod.generate_mixed_run(
                rng, sc, np.array([[6.0, 0.0], [2.0, 3.0]]),
                np.array([[0.0, 0.2], [0.1, -0.1]]),
                control_noise=(0.1, 0.01), return_labels=True)
        return [sc.landmarks, sc.traj, sc.controls_true], list(out)

    _assert_tree_equal(run(TSD), run(JSD))


def test_loaders_match_jax(tmp_path):
    """Every loader on files the simdata writer makes (an empty measurement
    line included, which both loaders drop), labeled triples, timestamps,
    a trajectory and the padding."""
    sc = JSD.make_scenario(np.random.default_rng(2), n_landmarks=8,
                           n_steps=10, clutter_rate=1.0)
    controls, meas = JSD.generate_run(np.random.default_rng(3), sc)
    meas[4] = meas[4][:0]
    JSD.write_run_files(str(tmp_path), controls, meas)
    (tmp_path / "lab.txt").write_text(
        "% r b label\n1.0 0.1 0\n2.0 -0.2 1 3.0 0.3 0\n\n4.0 0.0 1\n")
    (tmp_path / "times.txt").write_text("0.5\n1.0\n2.5\n\n")
    (tmp_path / "traj.txt").write_text(
        "% px py pt vx vy vt\n" + "\n".join(
            " ".join(str(v) for v in row) for row in np.concatenate(
                [sc.traj[:5], np.zeros((5, 3))], 1)) + "\n")
    for mod_args in (("load_measurements", "measurements.txt", {}),
                     ("load_measurements", "lab.txt", {"labeled": True}),
                     ("load_controls", "controls.txt", {}),
                     ("load_timestamps", "times.txt", {}),
                     ("load_timestamps", "missing.txt", {}),
                     ("load_trajectory", "traj.txt", {})):
        name, fname, kw = mod_args
        ref = getattr(JL, name)(str(tmp_path / fname), **kw)
        got = getattr(TL, name)(str(tmp_path / fname), **kw)
        if name == "load_measurements":
            assert len(got) == len(ref)
            for g, r in zip(got, ref):
                _assert_tree_equal(list(dataclasses.astuple(g)),
                                   list(dataclasses.astuple(r)))
            sets = (got, ref)
        elif ref is None:
            assert got is None
        else:
            assert len(ref)
            np.testing.assert_array_equal(got, ref)
    _assert_tree_equal(list(TL.pad_measurement_sets(sets[0], 3)),
                       list(JL.pad_measurement_sets(sets[1], 3)))


def test_write_state_estimate_log_same_bytes(tmp_path):
    """Both writers, with a static and a dynamic map, the t = 0 repeat and
    the PHD cardinality line; then the loop-time and metrics appenders."""
    rng = np.random.default_rng(0)
    f, fd, P = 5, 3, 4
    args = dict(
        expected_pose=rng.normal(size=6).astype(np.float32),
        static_w=rng.uniform(0, 1, f), static_mean=rng.normal(size=(f, 2)),
        static_cov=rng.normal(size=(f, 2, 2)),
        dynamic_w=np.array([0.5, 0.0, 0.25]),
        dynamic_mean=rng.normal(size=(fd, 4)),
        dynamic_cov=rng.normal(size=(fd, 4, 4)),
        particle_log_weights=np.log(np.full(P, 1.0 / P, np.float32)),
        particle_poses=rng.normal(size=(P, 6)).astype(np.float32),
        resample_idx=np.arange(P), max_cardinality=7, repeat=2)
    out = {}
    for tag, mod in (("jax", JLG), ("port", TLG)):
        d = tmp_path / tag
        d.mkdir()
        mod.write_state_estimate_log(str(d), 3, **args)
        mod.append_loop_time(str(d), 1.234567)
        mod.append_metrics_jsonl(str(d), dict(t=3, ms=1.5))
        out[tag] = {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}
    assert out["port"] == out["jax"]
    assert len(out["jax"]) == 3
    log = TLG.read_state_estimate_log(str(tmp_path / "port"
                                          / "state_estimate00003.log"))
    assert log["dynamic"].shape == (2, 21)


# ---- the host copies of the FastSLAM and runner surfaces ----

def _jcbb_case():
    """test_fastslam.py's case: two landmarks 0.12 rad apart at range 10, a
    0.1 rad yaw error that makes nearest-neighbour association mispair."""
    landmarks = np.array([[10.0, 0.0],
                          [10.0 * np.cos(0.12), 10.0 * np.sin(0.12)]])
    landmark_covs = np.tile(np.diag([0.01, 0.01]), (2, 1, 1))
    z = np.array([[10.0, 0.12 - 0.1], [10.0, 0.0 - 0.1]])
    return z, landmarks, landmark_covs, np.zeros(3), np.diag(
        [1e-4, 1e-4, 0.06 ** 2])


def _random_jcbb_case(seed):
    rng = np.random.default_rng(seed)
    f = 6
    lm = np.stack([rng.uniform(3, 12, f), rng.uniform(-6, 6, f)], 1)
    covs = np.stack([np.diag(rng.uniform(0.01, 0.2, 2)) for _ in range(f)])
    pose = np.array([0.1, -0.2, 0.05])
    idx = rng.permutation(f)[:4]
    d = lm[idx] - pose[:2]
    z = np.stack([np.hypot(d[:, 0], d[:, 1]) + rng.normal(0, 0.1, 4),
                  np.arctan2(d[:, 1], d[:, 0]) - pose[2]
                  + rng.normal(0, 0.02, 4) + 0.04], 1)
    z = np.vstack([z, [rng.uniform(2, 10), rng.uniform(-1, 1)]])
    return z, lm, covs, pose, np.diag([0.01, 0.01, 0.03 ** 2])


@pytest.mark.parametrize("case", ["two_landmarks", "clutter", 0, 1, 2])
def test_jcbb_and_nn_match_jax(case):
    from phdslam_tpu.ops import jcbb as JJ
    from phdslam_tpu_torch.ops import jcbb as TJ
    if case == "two_landmarks":
        args = _jcbb_case()
    elif case == "clutter":
        z, *rest = _jcbb_case()
        args = (np.vstack([z, [10.0, 1.5]]), *rest)
    else:
        args = _random_jcbb_case(case)
    for name in ("jcbb", "nn_associate"):
        np.testing.assert_array_equal(getattr(TJ, name)(*args, 0.1, 0.01),
                                      getattr(JJ, name)(*args, 0.1, 0.01))
    if case == "two_landmarks":
        np.testing.assert_array_equal(TJ.jcbb(*args, 0.1, 0.01), [1, 0])


def _mixtures(seed, P=5, F=12, d=2, clustered=False):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.0, 1.0, (P, F)) * (rng.uniform(size=(P, F)) < 0.7)
    mean = rng.normal(0, 3.0, (P, F, d))
    if clustered:               # every particle's map of the same 9 points
        mean = rng.normal(0, 6.0, (9, d))[rng.integers(0, 9, (P, F))] \
            + rng.normal(0, 0.3, (P, F, d))
    a = rng.normal(0, 0.5, (P, F, d, d))
    cov = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d)
    lw = rng.normal(0, 1.0, P)
    return lw - np.log(np.exp(lw).sum()), w, mean, cov


@pytest.mark.parametrize("d,P,clustered", [(2, 5, False), (4, 5, False),
                                         (2, 40, True), (4, 24, True)])
def test_reduce_mixture_and_eap_map_match_jax(d, P, clustered):
    """reduce_mixture_np (its distances batched per head) exactly against
    JAX's NumPy one (a pair at a time); eap_map_np against JAX's (which
    runs the optional native reducer where it is built) to rtol 1e-6.
    Random maps, and many particles' maps of the same points (most
    components merge)."""
    from phdslam_tpu.filter import estimate as JE
    from phdslam_tpu.ops import gm as JGM
    from phdslam_tpu_torch.filter import estimate as TE
    from phdslam_tpu_torch.ops import gm as TGM
    lw, w, mean, cov = _mixtures(d, P=P, d=d, clustered=clustered)
    sel = w > 0
    for a, b in zip(TGM.reduce_mixture_np(w[sel], mean[sel], cov[sel], 2.0),
                    JGM.reduce_mixture_np(w[sel], mean[sel], cov[sel], 2.0)):
        np.testing.assert_array_equal(a, b)
    got = TE.eap_map_np(lw, w, mean, cov, 2.0)
    ref = JE.eap_map_np(lw, w, mean, cov, 2.0)
    assert 0 < len(got[0]) < sel.sum()
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)
    empty = TE.eap_map_np(lw, np.zeros_like(w), mean, cov, 2.0)
    assert [x.shape for x in empty] == [(0,), (0, d), (0, d, d)]


@pytest.mark.parametrize("m,n", [(0, 0), (0, 3), (4, 0), (5, 9), (9, 5),
                                 (7, 7)])
def test_ospa_np_matches_jax(m, n):
    from phdslam_tpu.ops.ospa import ospa_np as j_ospa
    from phdslam_tpu_torch.ops.ospa import ospa_np as t_ospa
    rng = np.random.default_rng(m * 10 + n)
    x = rng.uniform(-10, 10, (m, 2))
    y = rng.uniform(-10, 10, (n, 2))
    for p, c in ((1.0, 5.0), (2.0, 10.0)):
        np.testing.assert_allclose(t_ospa(x, y, p=p, c=c),
                                   j_ospa(x, y, p=p, c=c), rtol=0, atol=1e-9)


def test_write_particles_mat_matches_jax(tmp_path):
    """One state (static and dynamic maps, CPHD-free) through both writers
    with MAP and EAP maps: the two files read back with scipy.io.loadmat
    hold the same fields."""
    import jax
    import jax.numpy as jnp
    from scipy.io import loadmat

    from phdslam_tpu.filter.state import Gaussian2DMixture as JG2
    from phdslam_tpu.filter.state import Gaussian4DMixture as JG4
    from phdslam_tpu.filter.state import SlamState as JState
    from phdslam_tpu.io import matdump as JM
    from phdslam_tpu_torch import bridge
    from phdslam_tpu_torch.filter.state import SlamState as TState
    from phdslam_tpu_torch.io import matdump as TM

    cfg = TC.load_config("cfg/mixed_synth.cfg").replace(
        n_particles=4, maxFeatures=6)
    rng = np.random.default_rng(1)
    t = TState.create(cfg)
    rnd = lambda x: torch.as_tensor(rng.normal(size=tuple(x.shape)),
                                    dtype=torch.float32)
    t = t.map(rnd).replace(resample_idx=torch.tensor([0, 0, 2, 3],
                                                     dtype=torch.int32))
    t.map_static.w[:, ::2] = 0.0
    t.map_dynamic.w[:, 1::3] = 0.0
    t.map_static.w.abs_()
    t.map_dynamic.w.abs_()
    h = bridge.state_to_numpy(t)
    jstate = jax.device_get(JState(
        pose=jnp.asarray(h["pose"]), log_weights=jnp.asarray(
            h["log_weights"]),
        map_static=JG2(**{k: jnp.asarray(v)
                          for k, v in h["map_static"].items()}),
        map_dynamic=JG4(**{k: jnp.asarray(v)
                           for k, v in h["map_dynamic"].items()}),
        resample_idx=jnp.asarray(h["resample_idx"]),
        variances=jnp.asarray(h["variances"])))
    view = bridge.host_view(t)
    np.testing.assert_array_equal(view.map_dynamic.cov,
                                  np.asarray(jstate.map_dynamic.cov))
    np.testing.assert_array_equal(view.map_static.cov,
                                  np.asarray(jstate.map_static.cov))
    est = dict(max_map_static=(np.ones(2), np.ones((2, 2)),
                               np.tile(np.eye(2), (2, 1, 1))),
               exp_map_dynamic=(np.ones(1), np.ones((1, 4)),
                                np.eye(4)[None]))
    paths = []
    for tag, mod, s in (("jax", JM, jstate), ("port", TM, view)):
        (tmp_path / tag).mkdir()
        paths.append(mod.write_particles_mat(str(tmp_path / tag), 7, s,
                                             **est))
    a, b = (loadmat(p)["particles"][0, 0] for p in paths)
    assert a.dtype.names == b.dtype.names
    for name in a.dtype.names:
        fa, fb = a[name], b[name]
        if fa.dtype.names:
            for e, g in zip(fa.ravel(), fb.ravel()):
                for k in fa.dtype.names:
                    np.testing.assert_array_equal(g[k], e[k])
        else:
            np.testing.assert_array_equal(fb, fa)
    back = TM.read_particles_mat(paths[1])
    assert len(back["maps_dynamic"]["weights"]) == 4


def test_build_player_matches_jax(tmp_path):
    """Both players on the same log directory write the same HTML."""
    from phdslam_tpu.eval.player import build_player as j_player
    from phdslam_tpu_torch.eval.player import build_player as t_player
    rng = np.random.default_rng(2)
    d = tmp_path / "logs"
    d.mkdir()
    for t in range(4):
        f = 5
        TLG.write_state_estimate_log(
            str(d), t, rng.normal(size=6).astype(np.float32),
            rng.uniform(0, 1, f), rng.normal(size=(f, 2)),
            np.tile(np.eye(2) * 0.3, (f, 1, 1)),
            particle_log_weights=np.full(6, -np.log(6), np.float32),
            particle_poses=rng.normal(size=(6, 6)).astype(np.float32),
            resample_idx=np.arange(6), max_cardinality=7)
    out = [fn(str(d), str(tmp_path / f"{tag}.html"), stride=s)
           for s in (1, 2)
           for tag, fn in ((f"jax{s}", j_player), (f"port{s}", t_player))]
    pages = [open(p).read() for p in out]
    assert pages[0] == pages[1] and pages[2] == pages[3]
    assert pages[0] != pages[2]


def test_matplotlib_logplayer(tmp_path):
    """The port's LogPlayer (tests/test_aux.py::test_matplotlib_logplayer
    on the copy): headless on Agg it steps frames and takes the key
    events; on the same logs its trajectory, cardinality curve and drawn
    artists equal the JAX package's LogPlayer's."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from phdslam_tpu.eval import player as JPL
    from phdslam_tpu_torch.eval import player as TPL

    for t in range(3):
        TLG.write_state_estimate_log(
            str(tmp_path), t, np.array([float(t), 1.0, 0.1, 0, 0, 0]),
            np.array([1.0, 0.5]), np.array([[1.0, 2.0], [3.0, 4.0]]),
            np.tile(np.eye(2) * 0.1, (2, 1, 1)),
            particle_log_weights=np.full(4, -np.log(4)),
            particle_poses=np.zeros((4, 6)), resample_idx=np.arange(4),
            max_cardinality=255)
    player = TPL.LogPlayer(TPL._load_records(str(tmp_path)),
                           true_map=np.array([[1.0, 2.0]]))
    ref = JPL.LogPlayer(JPL._load_records(str(tmp_path)),
                        true_map=np.array([[1.0, 2.0]]))
    assert player.n_steps == 3
    assert np.allclose(player.card_est, 1.5)      # intensity mass
    player.show_frame(2)
    ref.show_frame(2)
    assert player.frame == 2
    assert np.allclose(player.l_pose.get_xdata(), [2.0])
    # both features above min_weight = 0.33: two live ellipse artists
    live = [ln for ln in player.l_ellipses if len(ln.get_xdata())]
    assert len(live) == 2
    np.testing.assert_array_equal(player.est_traj_xy, ref.est_traj_xy)
    np.testing.assert_array_equal(player.card_est, ref.card_est)
    for a, b in zip(player.l_ellipses, ref.l_ellipses):
        np.testing.assert_array_equal(a.get_xydata(), b.get_xydata())

    class _Evt:
        def __init__(self, key):
            self.key = key

    # keyboard contract: left steps back, space toggles play
    player._on_key(_Evt("left"))
    assert player.frame == 1
    player._on_key(_Evt(" "))
    assert player.playing
    player._on_key(_Evt("escape"))
    assert not player.playing
    plt.close("all")
    # --gui refuses a non-interactive backend and writes nothing
    assert TPL.main([str(tmp_path), "--gui", "--fps", "5",
                     "--min-weight", "0.5"]) == 1
    assert not (tmp_path / "player.html").exists()


@pytest.mark.parametrize("seed", range(3))
def test_plots_ellipse_points_match_jax(seed):
    """eval/plots.py's copy: the same 3-sigma ellipse polylines (the
    drawing functions import matplotlib, which the GPU machine lacks; the
    geometry under them is plain numpy)."""
    from phdslam_tpu.eval import plots as JP
    from phdslam_tpu_torch.eval import plots as TP
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(2, 2))
    cov = a @ a.T + (0 if seed == 2 else 0.1) * np.eye(2)   # 2: singular-ish
    mean = rng.normal(0, 5, 2)
    for kw in ({}, dict(n_sigma=2.0, n_pts=7)):
        ref = JP._ellipse_points(mean, cov, **kw)
        got = TP._ellipse_points(mean, cov, **kw)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)

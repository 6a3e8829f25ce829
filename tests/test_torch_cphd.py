"""The port's CPHD filter (``filter/cphd.py``, the ESF kernel's plain
version ``kernels/esf.py``) against ``phdslam_tpu.filter.cphd`` on the same
seeded inputs, three CPHD SLAM steps with JAX's draws replayed, the
Poisson-prior identity (CPHD = PHD) and the runner's cardinality log line.

Routes: on the CPU JAX's ``cphd_update`` takes its XLA branch (scale every
[P, M, F] detection term, then take the top-k1); the port takes the kernel
branch (top-k1 of the raw terms, then scale). The scale is one number per
(particle, measurement), so both pick the same terms except at exact ties
and at the pruning threshold, where the terms carry no weight.

Tolerances: constants, cardinality prediction and ESFs rtol 1e-5 / atol
1e-4 (float32 cumulative sums and logaddexp chains); psi terms and
cardinalities rtol 1e-4 / atol 1e-3 in the log domain (logsumexp over up to
N + 1 terms of magnitude ~100); maps rtol 2e-4 / atol 1e-4, as the PHD step
tests; resample indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.config import load_config as jax_load_config
from phdslam_tpu.filter import cphd as JC
from phdslam_tpu.filter import step as JS
from phdslam_tpu.filter.state import Gaussian2DMixture as JG2
from phdslam_tpu.filter.state import Measurements as JMeas
from phdslam_tpu.filter.state import SlamState as JState
from phdslam_tpu_torch import load_config, runner, simdata
from phdslam_tpu_torch.bridge import state_from_numpy
from phdslam_tpu_torch.filter import cphd as TC
from phdslam_tpu_torch.filter import step as TS
from phdslam_tpu_torch.filter import update as TU
from phdslam_tpu_torch.filter.state import Gaussian2DMixture as TG2
from phdslam_tpu_torch.filter.state import Measurements as TMeas
from phdslam_tpu_torch.filter.state import SlamState as TState
from phdslam_tpu_torch.io.logs import read_state_estimate_log
from phdslam_tpu_torch.kernels import esf as TE

torch.set_num_threads(1)

TOL_C = dict(rtol=1e-5, atol=1e-4)
TOL_LOG = dict(rtol=1e-4, atol=1e-3)
TOL_MAP = dict(rtol=2e-4, atol=1e-4)
CPHD = dict(n_particles=8, maxFeatures=16, maxMeasurements=8,
            birthWeight=1e-2, y0=0.0, filterType=1, maxCardinality=31,
            gateBirths=True, gateThreshold=4.0)


@pytest.fixture(scope="module")
def cfgs():
    f = "cfg/ackerman_synth.cfg"
    return jax_load_config(f).replace(**CPHD), load_config(f).replace(**CPHD)


def _t(a):
    return torch.as_tensor(np.array(a))


def test_constants_match_jax(cfgs):
    jcfg, tcfg = cfgs
    for j, t in zip(JC.make_constants(jcfg), TC.make_constants(tcfg)):
        j = np.asarray(j)
        fin = np.isfinite(j)
        np.testing.assert_array_equal(np.isfinite(t.numpy()), fin)
        np.testing.assert_allclose(t.numpy()[fin], j[fin], **TOL_C)


def test_cardinality_predict_and_births_match_jax(cfgs, rng):
    jcfg, tcfg = cfgs
    n = jcfg.maxCardinality + 1
    prior = np.log(rng.dirichlet(np.ones(n), 4)).astype(np.float32)
    births = np.log(rng.dirichlet(np.ones(n), 4)).astype(np.float32)
    births[:, 5:] = -np.inf
    ref = JC.cardinality_predict(jnp.asarray(prior), jnp.asarray(births))
    got = TC.cardinality_predict(_t(prior), _t(births))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL_C)

    jconsts, tconsts = JC.make_constants(jcfg), TC.make_constants(tcfg)
    nb = np.array([0, 1, 5, 8], np.int32)
    ref = jax.vmap(lambda k: JC.birth_cardinality(k, 0.3, jconsts))(
        jnp.asarray(nb))
    got = TC.birth_cardinality(_t(nb), 0.3, tconsts)
    ref = np.asarray(ref)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)
    np.testing.assert_allclose(got.numpy()[fin], ref[fin], **TOL_C)


@pytest.mark.parametrize("P,M,n_pad", [(4, 7, 2), (3, 16, 0), (2, 1, 0),
                                       (5, 8, 3)])
def test_esf_forms_match_jax(rng, P, M, n_pad):
    """esf_log, esf_deleted and the divide-and-conquer esf_all (-inf forms)
    against JAX's; the ESF kernel's plain version with its -1e30 sentinel
    where JAX has -inf, and the same finite entries."""
    ll = rng.uniform(-8.0, 4.0, (P, M)).astype(np.float32)
    if n_pad:
        ll[:, M - n_pad:] = -np.inf
    e_ref = np.asarray(JC.esf_log(jnp.asarray(ll)))
    d_ref = np.asarray(JC.esf_deleted(jnp.asarray(ll)))
    fin_e, fin_d = np.isfinite(e_ref), np.isfinite(d_ref)
    outs = dict(scan=(TC.esf_log(_t(ll)), TC.esf_deleted(_t(ll))),
                tree=TC.esf_all(_t(ll)))
    for name, (e, d) in outs.items():
        assert e.shape == (P, M + 1) and d.shape == (P, M, M), name
        np.testing.assert_array_equal(np.isfinite(e.numpy()), fin_e)
        np.testing.assert_array_equal(np.isfinite(d.numpy()), fin_d)
        np.testing.assert_allclose(e.numpy()[fin_e], e_ref[fin_e], **TOL_C)
        np.testing.assert_allclose(d.numpy()[fin_d], d_ref[fin_d], **TOL_C)
    e, d = TE.esf_all_plain(_t(ll))
    np.testing.assert_allclose(e.numpy()[fin_e], e_ref[fin_e], **TOL_C)
    np.testing.assert_allclose(d.numpy()[fin_d], d_ref[fin_d], **TOL_C)
    assert (e.numpy()[~fin_e] < -1e29).all()
    assert (d.numpy()[~fin_d] < -1e29).all()
    np.testing.assert_array_equal(np.exp(e.numpy()[~fin_e]), 0.0)


def test_esf_entry_point_dispatches_to_plain_on_cpu(rng):
    ll = _t(rng.normal(-1, 1, (3, 5)).astype(np.float32))
    before = TE.launches
    got = TE.esf_all(ll)
    ref = TE.esf_all_plain(ll)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert TE.launches == before


def _psi_inputs(rng, P, F, M, ncard):
    sum_l = rng.normal(-3, 2, (P, M)).astype(np.float32)
    sum_l[0, 1] = -np.inf                   # a measurement no feature sees
    z_valid = np.arange(M) < M - 2          # two padded slots
    w = ((rng.uniform(size=(P, F)) < 0.6)
         * rng.uniform(0.05, 1.0, (P, F))).astype(np.float32)
    mask = (w > 0) & (rng.uniform(size=(P, F)) < 0.8)
    pd = np.where(rng.uniform(size=(P, F)) < 0.7, 0.95, 0.0)
    qdw = np.where(mask, np.log(1 - pd) + np.log(np.maximum(w, 1e-30)),
                   -np.inf).astype(np.float32)
    cn = np.log(rng.dirichlet(np.ones(ncard), P)).astype(np.float32)
    return sum_l, qdw, w, mask, z_valid, cn


def test_psi_terms_match_jax(cfgs, rng):
    """The port's psi_terms (ESFs from the kernel's plain version, -1e30
    for empty coefficients) against JAX's (-inf): the same cn_update,
    log_lik, scale_detect and scale_nondetect, and the same after exp."""
    jcfg, tcfg = cfgs
    ncard = jcfg.maxCardinality + 1
    args = _psi_inputs(rng, 6, 16, 8, ncard)
    ref = JC.psi_terms(*(jnp.asarray(a) for a in args[:5]),
                       jnp.asarray(args[5]), JC.make_constants(jcfg), jcfg)
    got = TC.psi_terms(*(_t(a) for a in args[:5]), _t(args[5]),
                       TC.make_constants(tcfg), tcfg)
    for name in ref._fields:
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        fin = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=name)
        np.testing.assert_allclose(g[fin], r[fin], err_msg=name, **TOL_LOG)
    # after exp, as the update uses them (the posterior cardinality pmf)
    np.testing.assert_allclose(np.exp(got.cn_update.numpy()),
                               np.exp(np.asarray(ref.cn_update)), rtol=1e-3,
                               atol=1e-7)
    np.testing.assert_allclose(np.exp(got.cn_update.numpy()).sum(1), 1.0,
                               rtol=1e-4)


def _map(rng, P, F):
    w = ((rng.uniform(size=(P, F)) < 0.5)
         * rng.uniform(0.1, 1.0, (P, F))).astype(np.float32)
    mx = rng.uniform(-8, 8, (P, F)).astype(np.float32)
    my = rng.uniform(-8, 8, (P, F)).astype(np.float32)
    c = np.full((P, F), 0.2, np.float32)
    z = np.zeros((P, F), np.float32)
    return ((JG2(*(jnp.asarray(a) for a in (w, mx, my, c, z, c))),
             TG2(*(_t(a) for a in (w, mx, my, c, z, c)))))


def _meas(rng, M, n_valid):
    rb = np.stack([rng.uniform(0.5, 9.0, M), rng.uniform(-1.0, 1.0, M)],
                  1).astype(np.float32)
    valid = np.arange(M) < n_valid
    return rb, valid


def _cmp_map(tm, jm, tag, sort=False, **tol):
    for name in ("w", "mx", "my", "c00", "c01", "c11"):
        g, r = getattr(tm, name).numpy(), np.asarray(getattr(jm, name))
        if sort:
            g, r = np.sort(g, -1), np.sort(r, -1)
        np.testing.assert_allclose(g, r, err_msg=f"{tag} {name}", **tol)


@pytest.mark.parametrize("gate", [False, True])
def test_add_births_matches_jax(cfgs, rng, gate):
    jcfg, tcfg = cfgs
    jcfg, tcfg = (c.replace(gateBirths=gate) for c in cfgs)
    P, F, M = 6, 16, 8
    jm, tm = _map(rng, P, F)
    pose = rng.uniform(-1, 1, (P, 6)).astype(np.float32)
    rb, valid = _meas(rng, M, 6)
    rb[0] = [np.hypot(float(jm.mx[0, 0]), float(jm.my[0, 0])) + 0.05, 0.0]
    jmap, jcb = JC.add_births(jm, jnp.asarray(pose), jnp.asarray(rb),
                              jnp.asarray(valid), jcfg,
                              JC.make_constants(jcfg))
    tmap, tcb = TC.add_births(tm, _t(pose), _t(rb), _t(valid), tcfg,
                              TC.make_constants(tcfg))
    _cmp_map(tmap, jmap, f"gate={gate}", rtol=1e-5, atol=1e-5)
    jcb = np.asarray(jcb)
    fin = np.isfinite(jcb)
    np.testing.assert_array_equal(np.isfinite(tcb.numpy()), fin)
    np.testing.assert_allclose(tcb.numpy()[fin], jcb[fin], **TOL_C)


@pytest.mark.parametrize("by_index,merge_mode", [
    pytest.param(False, 0, id="False"), pytest.param(True, 0, id="True"),
    pytest.param(False, 1, id="False-merge_mode1"),
    pytest.param(True, 1, id="True-merge_mode1")])
def test_cphd_update_matches_jax_xla_branch(cfgs, rng, by_index, merge_mode):
    """The CPHD update against JAX's XLA branch; merge_mode 1 takes the
    top-4 detection terms and prunes at merge_min_weight before the merge
    (``filter/cphd.py``'s fast path)."""
    fast = dict(mergeMode=1, mergeMinWeight=1e-2) if merge_mode else {}
    jcfg, tcfg = (c.replace(n_particles=16, selectByIndex=by_index, **fast)
                  for c in cfgs)
    P, F, M = 16, 16, 8
    jm, tm = _map(rng, P, F)
    pose = rng.uniform(-1, 1, (P, 6)).astype(np.float32)
    rb, valid = _meas(rng, M, 7)
    lab = np.zeros(M, np.int32)
    ncard = jcfg.maxCardinality + 1
    cn = np.full((P, ncard), -np.log(ncard), np.float32)
    jmap, jcn, jdw = JC.cphd_update(
        jnp.asarray(pose), jm, jnp.asarray(cn), jnp.asarray(rb),
        jnp.asarray(lab), jnp.asarray(valid), jcfg, JC.make_constants(jcfg))
    tmap, tcn, tdw = TC.cphd_update(
        _t(pose), tm, _t(cn), _t(rb), _t(lab), _t(valid), tcfg,
        TC.make_constants(tcfg))
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), **TOL_LOG)
    np.testing.assert_allclose(tcn.numpy(), np.asarray(jcn), **TOL_LOG)
    _cmp_map(tmap, jmap, "map", **TOL_MAP)
    assert float(tmap.w.sum()) > 0


def _draws(key, cfg, n_pred):
    """JAX's draws for slam_step(key): (normals [sub, P, 2], uniforms)."""
    k_pred, _k_var, k_res = jax.random.split(key, 3)
    sub = max(int(cfg.subdividePredict), 1)
    keys = jax.random.split(k_pred, sub)
    normals = np.stack([np.asarray(jax.random.normal(
        keys[i], (n_pred, 2), jnp.float32)) for i in range(sub)])
    u = np.asarray(jax.random.uniform(k_res, (cfg.n_particles,),
                                      jnp.float32))
    return _t(normals), _t(u)


@pytest.mark.parametrize("poisson", [True, False])
def test_three_cphd_steps_match_jax(cfgs, poisson):
    """Three CPHD SLAM steps from the same state with the same draws; the
    second and third take births from the previous measurements (and, with
    cnPoissonPredict off, the convolution prediction of the cardinality)."""
    jcfg, tcfg = (c.replace(cnPoissonPredict=poisson) for c in cfgs)
    sc = simdata.make_scenario(np.random.default_rng(11), n_landmarks=12,
                               n_steps=6, clutter_rate=2.0)
    controls, meas = simdata.generate_run(np.random.default_rng(12), sc,
                                          control_noise=(0.05, 0.005))
    jstate = JState.create(jcfg)
    tstate = state_from_numpy(jax.device_get(jstate))
    assert torch.equal(tstate.cn_birth, TState.create(tcfg).cn_birth)
    key = jax.random.PRNGKey(5)
    M = tcfg.maxMeasurements
    jprev = tprev = None
    for t in range(3):
        key, sk = jax.random.split(key)
        ctrl = controls[t - 1] if t > 0 else np.zeros(2, np.float32)
        rb = np.zeros((M, 2), np.float32)
        k = min(len(meas[t]), M)
        rb[:k] = meas[t][:k]
        valid = np.arange(M) < k
        lab = np.zeros(M, np.int32)
        zj = JMeas(rb=jnp.asarray(rb), label=jnp.asarray(lab),
                   valid=jnp.asarray(valid))
        zt = TMeas.from_numpy(rb, lab, valid)
        jstate, jaux = JS.slam_step(
            jstate, sk, (jnp.float32(ctrl[0]), jnp.float32(ctrl[1])), zj,
            jnp.float32(jcfg.dt), jnp.asarray(t > 0), jcfg, z_prev=jprev)
        tstate, taux = TS.slam_step(
            tstate, (float(ctrl[0]), float(ctrl[1])), zt, float(tcfg.dt),
            t > 0, tcfg, noise=_draws(sk, tcfg, tcfg.n_particles),
            z_prev=tprev)
        jprev, tprev = zj, zt
        j = jax.device_get(jstate)
        tag = f"step {t}"
        np.testing.assert_allclose(tstate.pose.numpy(), j.pose, err_msg=tag,
                                   **TOL_MAP)
        np.testing.assert_allclose(tstate.log_weights.numpy(), j.log_weights,
                                   err_msg=tag, **TOL_LOG)
        np.testing.assert_array_equal(tstate.resample_idx.numpy(),
                                      j.resample_idx, err_msg=tag)
        for name in ("cardinality", "cn_birth"):
            g, r = getattr(tstate, name).numpy(), getattr(j, name)
            fin = r > -1e30
            np.testing.assert_array_equal(g > -1e30, fin, err_msg=name)
            np.testing.assert_allclose(g[fin], r[fin], err_msg=f"{tag} {name}",
                                       **TOL_LOG)
        _cmp_map(tstate.map_static, j.map_static, tag, **TOL_MAP)
        np.testing.assert_allclose(taux.log_lik.numpy(),
                                   np.asarray(jaux.log_lik), **TOL_LOG)
    assert float(tstate.map_static.w.sum()) > 0


def test_poisson_prior_reduces_to_phd():
    """With a Poisson predicted cardinality whose mean is the in-range
    intensity mass, CPHD reduces to the PHD filter: a repeatedly detected
    feature follows the same confirmation path through both updates, with
    and without clutter-like extra measurements (the port's copy of
    tests/test_cphd.py::test_cphd_poisson_prior_reduces_to_phd)."""
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=1, maxFeatures=8, maxMeasurements=8, filterType=1,
        maxCardinality=63, gateBirths=False, birthWeight=1e-9)
    consts = TC.make_constants(cfg)
    pose = torch.zeros((1, 6))
    M = cfg.maxMeasurements
    var_r = (cfg.stdRange * cfg.birthNoiseFactor) ** 2
    var_b = (cfg.stdBearing * cfg.birthNoiseFactor) ** 2

    def fresh_map(w):
        z = torch.zeros((1, 8))
        one = lambda v: z.clone().index_fill_(1, torch.tensor([0]), v)
        return TG2(w=one(w), mx=one(5.0), my=z.clone(), c00=one(var_r),
                   c01=z.clone(), c11=one(25.0 * var_b))

    for n_extra in (0, 4):
        z_rb = torch.zeros((M, 2))
        z_rb[0, 0] = 5.0
        for i in range(n_extra):
            z_rb[1 + i] = torch.tensor([6.0 + i, 0.5 + 0.1 * i])
        z_valid = torch.arange(M) < (1 + n_extra)
        z_label = torch.zeros((M,), dtype=torch.int32)
        gm_p, gm_c = fresh_map(0.015), fresh_map(0.015)
        ncard = cfg.maxCardinality + 1
        cn = torch.full((1, ncard), -float(np.log(ncard)))
        for t in range(6):
            gm_p = TU.phd_update_static(pose, gm_p, z_rb, z_label, z_valid,
                                        cfg.replace(filterType=0)).map_out
            gm_c, cn, _ = TC.cphd_update(pose, gm_c, cn, z_rb, z_label,
                                         z_valid, cfg, consts)
            wp, wc = float(gm_p.w.max()), float(gm_c.w.max())
            assert abs(wp - wc) < 2e-3 + 0.02 * wp, (t, n_extra, wp, wc)
        assert wp > 0.8, wp


TINY_RUN = """
n_particles = 8
max_features = 16
max_measurements = 8
birth_weight = 0.02
std_encoder = 0.05
std_alpha = 0.005
initial_y = 0.0
filter_type = 1
max_cardinality = 31
"""


def test_runner_writes_cardinality_line(tmp_path):
    """filter_type = 1 through the synth runner: the last log line is the
    MAP particle's cardinality log-pmf (normalised), the same in loop and
    scan mode, and the vehicle is tracked."""
    T = 12
    sc = simdata.make_scenario(np.random.default_rng(11), n_landmarks=12,
                               n_steps=T, clutter_rate=2.0)
    controls, meas = simdata.generate_run(np.random.default_rng(21), sc,
                                          control_noise=(0.05, 0.005))
    assert all(len(z) for z in meas[:T])
    simdata.write_run_files(str(tmp_path), controls, meas[:T])
    with open("cfg/ackerman_synth.cfg") as f:
        (tmp_path / "c.cfg").write_text(f.read() + TINY_RUN)
    outs = {}
    for mode in ("loop", "scan"):
        outs[mode] = out = tmp_path / mode
        runner.main([str(tmp_path / "c.cfg"), "synth", "--measurements",
                     str(tmp_path / "measurements.txt"), "--controls",
                     str(tmp_path / "controls.txt"), "--out-dir", str(out),
                     "--device", "cpu", "--mode", mode])
    errs = []
    for t in range(T):
        name = f"state_estimate{t:05d}.log"
        assert (outs["loop"] / name).read_text() == \
            (outs["scan"] / name).read_text(), name
        cn = read_state_estimate_log(str(outs["loop"] / name))["cardinality"]
        # -inf is a zero probability (the Poisson prior of an empty in-range
        # submap); no NaN, and the pmf is normalised
        assert cn.shape == (32,) and np.isfinite(np.exp(cn)).all()
        assert abs(np.log(np.exp(cn).sum())) < 1e-3
        pose = read_state_estimate_log(str(outs["loop"] / name))["pose"]
        errs.append(np.linalg.norm(pose[:2] - sc.traj[t, :2]))
    assert np.mean(errs) < 2.0, errs

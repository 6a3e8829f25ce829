"""The island model on one device (``phdslam_tpu_torch/parallel/island.py``)
against ``phdslam_tpu/parallel/island.py`` on the virtual CPU devices of
``tests/conftest.py`` (one island a device), JAX on its XLA branches.

JAX keys island k's step with ``k_step, k_ex = split(fold_in(key, k))``
(its slam_step draws from k_step) and its butterfly round at a stride with
``fold_in(fold_in(fold_in(k_ex, min(k, partner)), stride), k)``; the test
makes those draws with jax.random and hands them to the port as
``noise``. Tolerances, the run axis's (``tests/test_torch_runs.py``):
rtol 1e-4 / atol 1e-5 on poses, weights and the aux values, rtol 2e-4 /
atol 1e-4 on maps, rtol 1e-4 / atol 1e-3 on CPHD log-domain values;
resample indices and the exchange flag exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec

from phdslam_tpu.config import load_config as jax_load_config
from phdslam_tpu.filter.state import Measurements as JMeas
from phdslam_tpu.filter.state import SlamState as JState
from phdslam_tpu.parallel import island as JI
from phdslam_tpu.simdata import generate_run, make_scenario
from phdslam_tpu_torch import load_config
from phdslam_tpu_torch.filter.predict import noise_dim
from phdslam_tpu_torch.filter.state import Measurements as TMeas
from phdslam_tpu_torch.filter.state import SlamState as TState
from phdslam_tpu_torch.parallel import island as TI

torch.set_num_threads(1)

TINY = dict(n_particles=16, maxFeatures=16, maxMeasurements=8,
            birthWeight=0.02, y0=0.0)
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_MAP = dict(rtol=2e-4, atol=1e-4)
TOL_LOG = dict(rtol=1e-4, atol=1e-3)
CFGS = {"static": ("cfg/ackerman_synth.cfg", {}),
        "cphd": ("cfg/ackerman_synth.cfg",
                 dict(filterType=1, maxCardinality=31)),
        "mixed": ("cfg/mixed_synth.cfg", {})}
T_STEPS = 3


def _cfgs(kind, **over):
    path, extra = CFGS[kind]
    kw = {**TINY, **extra, **over}
    return jax_load_config(path).replace(**kw), load_config(path).replace(**kw)


@pytest.fixture(scope="module")
def run():
    """T_STEPS padded measurement sets of a simdata run and its controls."""
    sc = make_scenario(np.random.default_rng(11), n_landmarks=12,
                       n_steps=6, clutter_rate=2.0)
    controls, meas = generate_run(np.random.default_rng(12), sc,
                                  control_noise=(0.05, 0.005))
    M = TINY["maxMeasurements"]
    sets = []
    for t in range(T_STEPS):
        rb = np.zeros((M, 2), np.float32)
        k = min(len(meas[t]), M)
        rb[:k] = meas[t][:k]
        sets.append((rb, np.zeros(M, np.int32), np.arange(M) < k))
    ctrl = [np.zeros(2, np.float32)] + [np.asarray(controls[t], np.float32)
                                        for t in range(T_STEPS - 1)]
    return sets, ctrl


def _jax_draws(key, cfg, n):
    """JAX's draws of island_slam_step(key), concatenated island by island:
    (normals [sub, P, d], resample uniforms [P], butterfly uniforms
    [rounds, P])."""
    p = cfg.n_particles // n
    sub = max(int(cfg.subdividePredict), 1)
    d = noise_dim(cfg)
    normals, uniforms, bfly = [], [], []
    for me in range(n):
        k_step, k_ex = jax.random.split(jax.random.fold_in(key, me))
        k_pred, _k_var, k_res = jax.random.split(k_step, 3)
        keys = jax.random.split(k_pred, sub)
        normals.append(np.stack([np.asarray(jax.random.normal(
            keys[i], (p, d), jnp.float32)) for i in range(sub)]))
        uniforms.append(np.asarray(jax.random.uniform(k_res, (p,),
                                                      jnp.float32)))
        rows = [np.zeros((0, p), np.float32)]
        for s in TI.butterfly_strides(n):
            k = jax.random.fold_in(k_ex, min(me, me ^ s))
            k = jax.random.fold_in(jax.random.fold_in(k, jnp.int32(s)), me)
            rows.append(np.asarray(jax.random.uniform(k, (1, p),
                                                      jnp.float32)))
        bfly.append(np.concatenate(rows))
    return (torch.as_tensor(np.concatenate(normals, 1)),
            torch.as_tensor(np.concatenate(uniforms)),
            torch.as_tensor(np.concatenate(bfly, 1)))


def _compare(kind, ts, tilw, taux, tla, js, jilw, jaux, jla, tag):
    j = jax.device_get(js)
    lw_tol = TOL_LOG if kind == "cphd" else TOL
    np.testing.assert_allclose(ts.pose.numpy(), j.pose, err_msg=tag, **TOL)
    np.testing.assert_allclose(ts.log_weights.numpy(), j.log_weights,
                               err_msg=tag, **lw_tol)
    np.testing.assert_array_equal(ts.resample_idx.numpy(), j.resample_idx,
                                  err_msg=tag)
    for name in ("w", "mx", "my", "c00", "c01", "c11"):
        np.testing.assert_allclose(getattr(ts.map_static, name).numpy(),
                                   getattr(j.map_static, name),
                                   err_msg=f"{tag} {name}", **TOL_MAP)
    if kind == "mixed":
        for name in ("w", "mean_channels", "cov_channels"):
            np.testing.assert_allclose(
                getattr(ts.map_dynamic, name).numpy(),
                getattr(j.map_dynamic, name), err_msg=f"{tag} dyn {name}",
                **TOL_MAP)
    if kind == "cphd":
        g, r = ts.cardinality.numpy(), j.cardinality
        fin = r > -1e30
        np.testing.assert_array_equal(g > -1e30, fin, err_msg=tag)
        np.testing.assert_allclose(g[fin], r[fin], err_msg=tag, **TOL_LOG)
    np.testing.assert_allclose(tilw.numpy(), np.asarray(jilw), err_msg=tag,
                               **lw_tol)
    for name in ("expected_pose", "island_logw", "island_neff", "log_lik"):
        np.testing.assert_allclose(getattr(taux, name).numpy(),
                                   np.asarray(getattr(jaux, name)),
                                   err_msg=f"{tag} {name}", **lw_tol)
    assert bool(taux.exchanged) == bool(jaux.exchanged), tag
    jl = jax.device_get(jla)
    for name in TI.IslandLogAux._fields:
        g, r = getattr(tla, name).numpy(), np.asarray(getattr(jl, name))
        if name == "resample_idx":
            np.testing.assert_array_equal(g, r, err_msg=tag)
        else:
            np.testing.assert_allclose(
                g, r, err_msg=f"{tag} {name}",
                **(lw_tol if name in ("best_score", "log_weights")
                   else TOL_MAP))


@pytest.mark.parametrize("kind,n,thresh", [
    ("static", 2, 1.1), ("static", 2, 0.0), ("static", 4, 1.1),
    ("static", 4, 0.0), ("cphd", 2, 1.1), ("cphd", 4, 0.0),
    ("mixed", 2, 0.0), ("mixed", 4, 1.1)])
def test_island_steps_match_jax(run, kind, n, thresh):
    """T_STEPS island steps from init (step 0 without prediction, each
    later one with the previous set as z_prev), the exchange forced
    (thresh 1.1) or never run (0); every step's state, island weights, aux
    and log aux against JAX's."""
    sets, ctrl = run
    jcfg, tcfg = _cfgs(kind)
    jstep, jinit = JI.island_slam_step(JI.make_island_mesh(n), jcfg, thresh,
                                       with_log_state=True)
    js, jilw = jinit()
    ts, tilw = TI.init_islands(tcfg, n, "cpu")
    np.testing.assert_array_equal(tilw.numpy(), np.asarray(jilw))
    np.testing.assert_array_equal(ts.log_weights.numpy(),
                                  np.asarray(js.log_weights))
    key = jax.random.PRNGKey(5)
    jprev = tprev = None
    for t, (rb, lab, valid) in enumerate(sets):
        key, sk = jax.random.split(key)
        zj = JMeas(rb=jnp.asarray(rb), label=jnp.asarray(lab),
                   valid=jnp.asarray(valid))
        zt = TMeas.from_numpy(rb, lab, valid)
        js, jilw, jaux, jla = jstep(js, jilw, sk, jnp.asarray(ctrl[t]), zj,
                                    jnp.float32(jcfg.dt), jnp.asarray(t > 0),
                                    z_prev=jprev)
        ts, tilw, taux, tla = TI.island_slam_step(
            ts, tilw, (float(ctrl[t][0]), float(ctrl[t][1])), zt,
            float(tcfg.dt), t > 0, tcfg, n, thresh=thresh,
            noise=_jax_draws(sk, tcfg, n), z_prev=tprev,
            with_log_state=True)
        jprev, tprev = zj, zt
        _compare(kind, ts, tilw, taux, tla, js, jilw, jaux, jla,
                 f"{kind} n={n} thresh={thresh} step {t}")
        assert bool(taux.exchanged) == (thresh > 1.0)
    if thresh > 1.0:
        # every exchange leaves the island weights at their mean
        np.testing.assert_allclose(tilw.numpy(), -np.log(n), atol=1e-5)
    assert np.isfinite(ts.pose.numpy()).all()


def test_butterfly_pool_mass_quirk_matches_jax():
    """n = 8 islands of 8 particles, equal island weights, uniform local
    weights: each pool's mass is 2/8, so the stratified walk overruns it
    from slot 2 on and the overrun guard sends those 6 slots to the pool's
    maximum-weight particle (its first, on the ties). JAX's
    _butterfly_round, under shard_map on 8 devices, and the port's
    butterfly_round take the same rows."""
    n, p = 8, 8
    P = n * p
    jcfg = jax_load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=P, maxFeatures=4, maxMeasurements=8)
    pose = np.zeros((P, 6), np.float32)
    pose[:, 0] = np.arange(P)
    lw = np.full(P, -np.log(p), np.float32)
    ilw = np.full(n, -np.log(n), np.float32)
    js = JState.create(jcfg).replace(pose=jnp.asarray(pose),
                                     log_weights=jnp.asarray(lw))
    mesh = JI.make_island_mesh(n)
    spec = jax.tree.map(lambda _: PartitionSpec(JI.AXIS), js)
    key = jax.random.PRNGKey(3)
    ax = PartitionSpec(JI.AXIS)

    @jax.jit
    def one_round(st, w):
        def body(s, x):
            s, w = JI._butterfly_round(s, x[0], key, 1, n)
            return s, w.reshape(1)

        return shard_map(
            body,
            mesh=mesh, in_specs=(spec, ax), out_specs=(spec, ax),
            check_vma=False)(st, w)

    jst, jw = one_round(js, jnp.asarray(ilw))
    j_rows = np.asarray(jst.pose)[:, 0].astype(np.int64)
    u = np.concatenate([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            key, min(me, me ^ 1)), jnp.int32(1)), me), (p,), jnp.float32))
        for me in range(n)])
    rows, merged = TI.butterfly_round(torch.as_tensor(lw),
                                      torch.as_tensor(ilw),
                                      torch.as_tensor(u), 1, n)
    np.testing.assert_array_equal(rows.numpy(), j_rows)
    np.testing.assert_allclose(merged.numpy(), np.asarray(jw), rtol=1e-6)
    first = (np.arange(n) * p)[:, None]
    on_max = (rows.numpy().reshape(n, p) == first).sum(1)
    assert (on_max >= 6).all(), rows.reshape(n, p)


def test_island_scan_equals_loop(run):
    """island_run_scan against island_slam_step in a Python loop, the same
    generator seed: every stacked value bit for bit."""
    sets, ctrl = run
    _, cfg = _cfgs("static")
    n = 4
    zs = [TMeas.from_numpy(*s) for s in sets]
    dts = [cfg.dt] * len(zs)
    st, ilw = TI.init_islands(cfg, n, "cpu")
    fs, filw, auxs, las = TI.island_run_scan(
        st, ilw, ctrl, zs, dts, cfg, n, thresh=0.9,
        generator=torch.Generator().manual_seed(2), with_log_state=True)
    g = torch.Generator().manual_seed(2)
    st, ilw = TI.init_islands(cfg, n, "cpu")
    z_prev = None
    for t, z in enumerate(zs):
        st, ilw, aux, la = TI.island_slam_step(
            st, ilw, (float(ctrl[t][0]), float(ctrl[t][1])), z,
            float(dts[t]), t > 0, cfg, n, thresh=0.9, generator=g,
            z_prev=z_prev, with_log_state=True)
        z_prev = z
        for a, b in zip(auxs, aux):
            assert torch.equal(a[t], b)
        for a, b in zip(las, la):
            assert torch.equal(a[t], b)
    assert torch.equal(st.pose, fs.pose) and torch.equal(ilw, filw)
    assert torch.equal(st.map_static.w, fs.map_static.w)


@pytest.mark.parametrize("n,over,match", [
    (3, {}, "power of 2"), (32, {}, "multiple"),
    (2, dict(nPredictParticles=2), "n_predict_particles")])
def test_island_preconditions_raise(n, over, match):
    _, cfg = _cfgs("static", **over)
    with pytest.raises(ValueError, match=match):
        TI.init_islands(cfg, n)
    st = TState.create(cfg)
    z = TMeas.empty(cfg.maxMeasurements)
    with pytest.raises(ValueError, match=match):
        TI.island_slam_step(st, torch.zeros(max(n, 1)), (0.0, 0.0), z,
                            0.1, False, cfg, n)

"""The Monte-Carlo run axis: R runs blockwise on the particle axis
(``phdslam_tpu_torch/filter/runs.py``), stepped together.

- The select and select4 plain versions (both modes) on R = 3 per-run
  measurement sets equal three single-run calls on the matching particle
  slices, bit for bit; so do ``neff``, ``stratified_resample_indices``,
  ``expected_pose`` and ``log_aux`` over each run.
- The batched ``slam_step`` against ``jax.vmap`` of JAX's ``slam_step``,
  static and CPHD, three runs of three steps, each run's draws replayed
  from its own key; JAX on the CPU takes its XLA branches. Tolerances: the
  step tests' (rtol 1e-4 / atol 1e-5 on poses and weights, rtol 2e-4 /
  atol 1e-4 on maps, rtol 1e-4 / atol 1e-3 on CPHD log-domain values),
  resample indices exactly.
- ``run_batch(vmapped=True)`` against ``run_batch(vmapped=False)`` run by
  run, for the static, CPHD, FastSLAM and mixed filters (the mixed with and
  without velocity-informed births), at the bars of
  ``tests/test_round3.py::test_vmapped_batch_matches_sequential`` (poses
  rtol 2e-4 / atol 2e-4, pose error atol 5e-4, OSPA rtol 2e-3 / atol
  5e-3); on the CPU the two come out bit for bit. Chunks of 2 against 3
  runs (``test_round3.py::test_vmapped_batch_chunking``).
- The per-run gate: a batch in which one run has an empty step and the
  others do not, against each run alone, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.filter import step as JS
from phdslam_tpu.filter.state import Measurements as JMeas
from phdslam_tpu.filter.state import SlamState as JState
from phdslam_tpu.simdata import generate_run, make_scenario
from phdslam_tpu_torch import load_config, simdata
from phdslam_tpu_torch.bridge import state_to_numpy
from phdslam_tpu_torch.eval import batch as TB
from phdslam_tpu_torch.filter import step as TS
from phdslam_tpu_torch.filter.estimate import expected_pose
from phdslam_tpu_torch.filter.predict import noise_dim
from phdslam_tpu_torch.filter.state import (Gaussian2DMixture,
                                            Gaussian4DMixture)
from phdslam_tpu_torch.filter.state import Measurements as TMeas
from phdslam_tpu_torch.filter.state import SlamState as TState
from phdslam_tpu_torch.filter.update import kalman_preupdate
from phdslam_tpu_torch.filter.update4 import kalman_preupdate4
from phdslam_tpu_torch.kernels import select as S
from phdslam_tpu_torch.kernels import select4 as S4
from phdslam_tpu_torch.ops.resample import neff, stratified_resample_indices

torch.set_num_threads(1)

R = 3
TINY = dict(n_particles=8, maxFeatures=16, maxMeasurements=8,
            birthWeight=1e-3, y0=0.0)
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_MAP = dict(rtol=2e-4, atol=1e-4)
TOL_LOG = dict(rtol=1e-4, atol=1e-3)
CFGS = {"static": ("cfg/ackerman_synth.cfg", {}),
        "cphd": ("cfg/ackerman_synth.cfg",
                 dict(filterType=1, maxCardinality=31)),
        "fastslam": ("cfg/fastslam_synth.cfg", {}),
        "mixed": ("cfg/mixed_synth.cfg", {}),
        "mixed_vel": ("cfg/mixed_synth.cfg", dict(birthVelocityInit=True))}


def _cfg(kind, **over):
    path, extra = CFGS[kind]
    return load_config(path).replace(**{**TINY, **extra, **over})


# ------------------------------------------------ kernels' plain versions --

def _select_inputs(P, F, M, seed):
    rng = np.random.default_rng(seed)
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=P, maxFeatures=F, maxMeasurements=M)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    c00 = rng.uniform(0.1, 2.0, (P, F))
    c11 = rng.uniform(0.1, 2.0, (P, F))
    gm = Gaussian2DMixture(
        w=t((rng.uniform(size=(P, F)) < 0.5)
            * rng.uniform(0.05, 1.0, (P, F))),
        mx=t(rng.uniform(-2, 12, (P, F))), my=t(rng.uniform(-10, 10, (P, F))),
        c00=t(c00), c01=t(0.3 * np.sqrt(c00 * c11)
                          * rng.uniform(-1, 1, (P, F))), c11=t(c11))
    pose = t(np.concatenate([rng.normal(0, 0.3, (P, 3)), np.zeros((P, 3))],
                            1))
    z = t(np.stack([rng.uniform(0.5, 10, (R, M)),
                    rng.uniform(-1.6, 1.6, (R, M))], -1))      # [R, M, 2]
    pre = kalman_preupdate(pose, gm, cfg)
    return cfg, [c.contiguous() for c in S.select_channels(pre, gm)], z


def _equal(got, ref):
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("by_index,raw", [(False, False), (False, True),
                                          (True, False)])
def test_select_plain_per_run_sets_equal_single_runs(by_index, raw):
    """R = 3 runs of 6 particles, each with its own set and n_valid: one
    call equals three single-run calls on the particle slices."""
    P, F, M = 6 * R, 16, 8
    cfg, chans, z = _select_inputs(P, F, M, 3)
    if by_index:
        chans = chans[:S.N_LOOP]
    nv = torch.tensor([8, 5, 0], dtype=torch.int32)
    kw = dict(k1=4, clutter_birth=float(cfg.clutterDensity
                                        + cfg.birthWeight),
              min_weight=float(cfg.minFeatureWeight), gate_threshold=9.0,
              raw=raw, with_compat=True, with_lpw=True, by_index=by_index)
    got = S.select_plain(chans, z, nv, **kw)
    n = P // R
    for r in range(R):
        one = S.select_plain([c[r * n:(r + 1) * n] for c in chans], z[r],
                             nv[r:r + 1], **kw)
        _equal([g[r * n:(r + 1) * n] for g in got], one)
    assert not got[1][2 * n:].any()             # run 2: n_valid 0


@pytest.mark.parametrize("by_index", [False, True])
def test_select4_plain_per_run_sets_equal_single_runs(by_index):
    P, F, M = 5 * R, 16, 8
    rng = np.random.default_rng(4)
    cfg = load_config("cfg/mixed_synth.cfg").replace(
        n_particles=P, maxFeatures=F, maxMeasurements=M)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    a = rng.normal(size=(P, F, 4, 4)) * 0.5
    cov = a @ np.swapaxes(a, -1, -2) + 0.2 * np.eye(4)
    gm = Gaussian4DMixture(
        w=t((rng.uniform(size=(P, F)) < 0.5)
            * rng.uniform(0.05, 1.0, (P, F))),
        mean_channels=t(np.concatenate([rng.uniform(-8, 8, (P, 2, F)),
                                        rng.normal(0, 0.5, (P, 2, F))], 1)),
        cov_channels=t(np.stack([cov[..., i, j] for i in range(4)
                                 for j in range(i, 4)], 1)))
    pose = t(np.concatenate([rng.normal(0, 0.3, (P, 3)), np.zeros((P, 3))],
                            1))
    z = t(np.stack([rng.uniform(0.5, 10, (R, M)),
                    rng.uniform(-1.6, 1.6, (R, M))], -1))
    loop, gain, mean, cov = S4.select4_channels(
        kalman_preupdate4(pose, gm, cfg), gm)
    pay = (None, None, None) if by_index else (gain, mean, cov)
    got = S4.select4_plain(loop, *pay, z, k1=4, by_index=by_index)
    n = P // R
    cut = lambda x, r: None if x is None else x[r * n:(r + 1) * n]
    for r in range(R):
        one = S4.select4_plain([c[r * n:(r + 1) * n] for c in loop],
                               *(cut(x, r) for x in pay), z[r], k1=4,
                               by_index=by_index)
        _equal([g[r * n:(r + 1) * n] for g in got], one)


# ------------------------------------------------- per-run reductions --

def test_per_run_reductions_equal_single_runs():
    """neff, the stratified resample (indices offset by r n, the
    past-the-end fallback the run's own argmax), the expected pose and
    log_aux over each run of R = 3 equal the single-run calls."""
    cfg = _cfg("cphd")
    n = cfg.n_particles
    rng = np.random.default_rng(5)
    state = TState.create(cfg, n_runs=R)
    assert state.n_particles == R * n
    lw = torch.as_tensor(rng.normal(0, 2, R * n).astype(np.float32))
    lw = torch.cat([x - torch.logsumexp(x, 0) for x in lw.split(n)])
    lw[n:2 * n] -= 1e-3          # run 1 sums below 1: past-the-end picks
    state = state.replace(
        log_weights=lw,
        pose=torch.as_tensor(rng.normal(0, 1, (R * n, 6)), dtype=torch.float32),
        map_static=state.map_static.replace(w=torch.as_tensor(
            rng.uniform(0, 1, (R * n, cfg.maxFeatures)),
            dtype=torch.float32)))
    u = torch.as_tensor(rng.uniform(size=R * n).astype(np.float32))
    u[2 * n - 1] = 0.99999994    # the last slot of run 1 past the end
    got_neff = neff(lw, R)
    got_idx = stratified_resample_indices(lw, u, n, R)
    got_pose = expected_pose(state, R)
    got_log = TS.log_aux(state, R)
    fell_back = False
    for r in range(R):
        sl = slice(r * n, (r + 1) * n)
        one = state.map(lambda t: t[sl])
        assert torch.equal(got_neff[r], neff(lw[sl]))
        idx = stratified_resample_indices(lw[sl], u[sl], n)
        assert torch.equal(got_idx[sl] - r * n, idx)
        fell_back |= bool((idx == torch.argmax(lw[sl])).any())
        assert torch.equal(got_pose[r], expected_pose(one))
        for g, o in zip(got_log, TS.log_aux(one)):
            assert torch.equal(g[r], o)
    assert fell_back


def test_measurements_and_state_carry_the_run_axis():
    valid = np.array([[1, 1, 0], [0, 0, 0], [1, 0, 0]], bool)
    z = TMeas.from_numpy(np.zeros((3, 3, 2)), np.zeros((3, 3)), valid)
    assert z.n_runs == 3 and z.count == (2, 0, 1)
    assert z.any_run and not z.every_run
    assert z.run_mask().tolist() == [True, False, True]
    one = TMeas.from_numpy(np.zeros((3, 2)), np.zeros(3), valid[0])
    assert one.n_runs is None and one.count == 2 and one.every_run
    empty = TMeas.empty(4, n_runs=2)
    assert empty.rb.shape == (2, 4, 2) and empty.count == (0, 0)
    cfg = _cfg("cphd")
    st = TState.create(cfg, n_runs=2)
    single = TState.create(cfg)
    for a, b in zip(TS.log_aux(st, 2), TS.log_aux(single)):
        assert torch.equal(a[0], b) and torch.equal(a[1], b)
    assert torch.equal(st.log_weights[:cfg.n_particles], single.log_weights)


# ----------------------------------------------------- against JAX vmap --

def _draws(key, cfg, n_pred):
    """JAX's draws for slam_step(key): (normals [sub, P, d], uniforms)."""
    k_pred, _k_var, k_res = jax.random.split(key, 3)
    sub = max(int(cfg.subdividePredict), 1)
    keys = jax.random.split(k_pred, sub)
    normals = np.stack([np.asarray(jax.random.normal(
        keys[i], (n_pred, noise_dim(cfg)), jnp.float32)) for i in range(sub)])
    u = np.asarray(jax.random.uniform(k_res, (cfg.n_particles,),
                                      jnp.float32))
    return torch.as_tensor(normals), torch.as_tensor(np.array(u))


def _sets(cfg, t_len, seed):
    """R runs' padded measurement sets [T, R, M, 2], [T, R, M] and their
    controls [T, R, 2]: one scenario, run r re-noised from seed + r."""
    sc = make_scenario(np.random.default_rng(11), n_landmarks=12,
                       n_steps=6, clutter_rate=2.0)
    M = cfg.maxMeasurements
    rb = np.zeros((t_len, R, M, 2), np.float32)
    valid = np.zeros((t_len, R, M), bool)
    ctrl = np.zeros((t_len, R, 2), np.float32)
    for r in range(R):
        controls, meas = generate_run(np.random.default_rng(seed + r), sc,
                                      control_noise=(0.05, 0.005))
        ctrl[1:, r] = controls[:t_len - 1]
        for t in range(t_len):
            k = min(len(meas[t]), M)
            rb[t, r, :k] = meas[t][:k]
            valid[t, r, :k] = True
    return rb, valid, ctrl


@pytest.mark.parametrize("kind", ["static", "cphd"])
def test_batched_step_matches_jax_vmap(tiny_cfg, kind):
    """Three steps of R = 3 runs: the port's one batched slam_step per step
    against jax.vmap of JAX's slam_step on the same draws."""
    cfg = _cfg(kind, birthWeight=0.02)
    jcfg = tiny_cfg.replace(birthWeight=0.02, **CFGS[kind][1])
    t_len = 3
    rb, valid, ctrl = _sets(cfg, t_len, 12)
    lab = np.zeros(valid.shape, np.int32)
    n = cfg.n_particles

    def one(st, key, c, z, zp, do_pred):
        return JS.slam_step(st, key, (c[0], c[1]), z, jnp.float32(jcfg.dt),
                            do_pred, jcfg, z_prev=zp)

    vstep = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, 0, None)))
    js = jax.tree.map(lambda x: jnp.stack([x] * R), JState.create(jcfg))
    ts = TState.create(cfg, n_runs=R)
    for a, b in zip(jax.tree.leaves(jax.device_get(js)),
                    [ts.pose, ts.log_weights, *vars(ts.map_static).values(),
                     *vars(ts.map_dynamic).values(), ts.resample_idx,
                     ts.variances, ts.cardinality, ts.cn_birth]):
        if b is not None:
            np.testing.assert_array_equal(
                np.asarray(a).reshape(b.shape), b.numpy())
    jmeas = lambda t: JMeas(rb=jnp.asarray(rb[t]), label=jnp.asarray(lab[t]),
                            valid=jnp.asarray(valid[t]))
    jprev = JMeas(rb=jnp.zeros_like(rb[0]), label=jnp.zeros_like(lab[0]),
                  valid=jnp.zeros_like(valid[0]))
    tprev = TMeas.empty(cfg.maxMeasurements, n_runs=R)
    keys = [jax.random.PRNGKey(5 + r) for r in range(R)]
    for t in range(t_len):
        step_keys = []
        for r in range(R):
            keys[r], sk = jax.random.split(keys[r])
            step_keys.append(sk)
        zj = jmeas(t)
        zt = TMeas.from_numpy(rb[t], lab[t], valid[t])
        js, jaux = vstep(js, jnp.stack(step_keys), jnp.asarray(ctrl[t]), zj,
                         jprev, jnp.asarray(t > 0))
        draws = [_draws(k, cfg, n) for k in step_keys]
        noise = (torch.cat([d[0] for d in draws], 1),
                 torch.cat([d[1] for d in draws]))
        ts, taux = TS.slam_step(
            ts, (torch.as_tensor(ctrl[t, :, 0]), torch.as_tensor(ctrl[t, :, 1])),
            zt, float(cfg.dt), t > 0, cfg, noise=noise, z_prev=tprev)
        jprev, tprev = zj, zt
        j = jax.device_get(js)
        tag = f"{kind} step {t}"
        flat = lambda a: np.asarray(a).reshape(R * n, *np.shape(a)[2:])
        np.testing.assert_allclose(ts.pose.numpy(), flat(j.pose),
                                   err_msg=tag, **TOL)
        np.testing.assert_allclose(ts.log_weights.numpy(),
                                   flat(j.log_weights), err_msg=tag,
                                   **(TOL_LOG if kind == "cphd" else TOL))
        np.testing.assert_array_equal(ts.resample_idx.numpy(),
                                      flat(j.resample_idx), err_msg=tag)
        for name in ("w", "mx", "my", "c00", "c01", "c11"):
            np.testing.assert_allclose(
                getattr(ts.map_static, name).numpy(),
                flat(getattr(j.map_static, name)), err_msg=f"{tag} {name}",
                **TOL_MAP)
        if kind == "cphd":
            g, r_ = ts.cardinality.numpy(), flat(j.cardinality)
            fin = r_ > -1e30
            np.testing.assert_array_equal(g > -1e30, fin, err_msg=tag)
            np.testing.assert_allclose(g[fin], r_[fin], err_msg=tag,
                                       **TOL_LOG)
        for name in ("expected_pose", "neff", "log_lik"):
            np.testing.assert_allclose(
                getattr(taux, name).numpy(), np.asarray(getattr(jaux, name)),
                err_msg=f"{tag} {name}",
                **(TOL_LOG if kind == "cphd" else TOL))
        np.testing.assert_array_equal(taux.resampled.numpy(),
                                      np.asarray(jaux.resampled))
        np.testing.assert_array_equal(taux.n_measure.numpy(),
                                      np.asarray(jaux.n_measure))
    assert float(ts.map_static.w.sum()) > 0


# --------------------------------------------- run_batch: vmapped paths --

@pytest.fixture(scope="module")
def scenario():
    return simdata.make_scenario(np.random.default_rng(0), n_landmarks=8,
                                 n_steps=8, clutter_rate=1.0)


@pytest.mark.parametrize("kind", ["static", "cphd", "fastslam", "mixed",
                                  "mixed_vel"])
def test_vmapped_batch_matches_sequential(scenario, kind):
    cfg = _cfg(kind, stdEncoder=0.05, stdAlpha=0.005)
    kw = dict(control_noise=(0.05, 0.005), device="cpu")
    seq = TB.run_batch(cfg, scenario, n_runs=R, **kw)
    vm = TB.run_batch(cfg, scenario, n_runs=R, vmapped=True, **kw)
    assert len(seq) == len(vm) == R
    for a, b in zip(seq, vm):
        np.testing.assert_allclose(a.poses, b.poses, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(a.pose_err, b.pose_err, atol=5e-4)
        np.testing.assert_allclose(a.ospa, b.ospa, rtol=2e-3, atol=5e-3)
        np.testing.assert_allclose(a.neff, b.neff, rtol=2e-4, atol=2e-4)
        assert np.isfinite(b.poses).all() and b.ms_per_step > 0


def test_vmapped_batch_chunking():
    """Chunks of 2 and of 3 runs filter the same runs."""
    sc = simdata.make_scenario(np.random.default_rng(1), n_landmarks=6,
                               n_steps=8, clutter_rate=1.0)
    cfg = _cfg("static", stdEncoder=0.05, stdAlpha=0.005)
    kw = dict(n_runs=R, control_noise=(0.05, 0.005), vmapped=True,
              collect_maps_every=0, device="cpu")
    full = TB.run_batch(cfg, sc, vmap_chunk=3, **kw)
    chunked = TB.run_batch(cfg, sc, vmap_chunk=2, **kw)
    for a, b in zip(full, chunked):
        np.testing.assert_allclose(a.poses, b.poses, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(a.neff, b.neff)


def _same_state(a, b):
    da, db = state_to_numpy(a), state_to_numpy(b)
    for k in da:
        if isinstance(da[k], dict):
            for c in da[k]:
                np.testing.assert_array_equal(da[k][c], db[k][c], err_msg=c)
        elif da[k] is None:
            assert db[k] is None
        else:
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)


@pytest.mark.parametrize("kind", ["static", "cphd", "fastslam", "mixed",
                                  "mixed_vel"])
def test_empty_step_of_one_run_is_gated_per_run(kind):
    """Run 1 has no measurement at steps 1 and 3 (no update, no resample;
    at steps 2 and 4 no CPHD births and, under birthVelocityInit, no
    velocity-informed dynamic births), the others have one at
    every step: the batch equals each run alone, bit for bit. A resample
    threshold above any nEff makes every update step resample."""
    cfg = _cfg(kind, birthWeight=0.02, resampleThresh=2.0)
    t_len = 5
    rb, valid, ctrl = _sets(cfg, t_len, 30)
    valid[1, 1] = valid[3, 1] = False
    rb[1, 1] = rb[3, 1] = 0.0
    assert valid[:, [0, 2]].any(-1).all()
    lab = np.zeros(valid.shape, np.int32)
    dts = np.full(t_len, cfg.dt, np.float32)
    gens = [torch.Generator().manual_seed(40 + r) for r in range(R)]
    zs = [TMeas.from_numpy(rb[t], lab[t], valid[t]) for t in range(t_len)]
    assert zs[1].count[1] == 0 and not zs[1].every_run
    final, (aux, logs) = TS.run_scan(TState.create(cfg, n_runs=R), ctrl, zs,
                                     dts, cfg, generator=gens,
                                     with_log_state=True)
    n = cfg.n_particles
    for r in range(R):
        g = torch.Generator().manual_seed(40 + r)
        zr = [TMeas.from_numpy(rb[t, r], lab[t, r], valid[t, r])
              for t in range(t_len)]
        one, (aux1, logs1) = TS.run_scan(TState.create(cfg), ctrl[:, r], zr,
                                         dts, cfg, generator=g,
                                         with_log_state=True)
        mine = final.map(lambda t: t[r * n:(r + 1) * n])
        _same_state(mine, one)
        for a, b in zip(aux, aux1):
            assert torch.equal(a[:, r], b)
        for a, b in zip(logs, logs1):
            assert torch.equal(a[:, r], b)
    assert not aux.resampled[1, 1] and float(aux.log_lik[1, 1]) == 0.0
    assert aux.resampled[1:, [0, 2]].all() and aux.resampled[[2, 4], 1].all()

"""Particle-axis sharding across processes (``parallel/mesh.py``) on the CPU:
gloo ranks spawned per rank count, a file rendezvous under tmp_path, one
torch thread each.

- Against the single process, bit for bit (every output byte equal): the
  sharded static, CPHD, mixed, FastSLAM, shotgun (nPredictParticles 2) and
  disparity steps over 3 steps at thresholds 1.1 (the resample forced) and
  0 (never), every step's aux and log values and the final state;
  ``sharded_run_scan`` with its log over 5 steps, and at 3 x 64
  particles a rank (an uneven lineage across the ranks' blocks); the
  disparity scan with its map log; the island step across ranks (n = 4
  and 8 islands: at 2
  and 4 ranks every mix of butterfly rounds within a rank and between
  ranks) against the one-device island step; at 2 and 4 ranks.
- What moves between ranks, from the mesh's traffic record (the port's
  counterpart of ``tests/test_multichip_evidence.py``'s HLO checks): a
  sharded step reads the device once and gathers the state's leaves only
  when its resample fires; a sharded disparity step gathers its pose,
  weights and clouds on every step, fired or not (JAX's ungated
  ``jnp.take``); an island step that does not exchange moves
  nothing larger than its [n/W, 6] expected poses, one that does swaps
  exactly log2(W) shards with partner ranks and gathers nothing larger;
  every kernel entry gets the rank's P/W rows.
- Against JAX: ``phdslam_tpu.parallel.mesh.sharded_step`` on 4 of
  conftest's virtual CPU devices (static and CPHD, 3 steps), the port's
  sharded step on 4 ranks replaying JAX's draws; rtol 1e-4 / atol 1e-5
  (``tests/test_distributed.py``'s tolerance), the maps rtol 2e-4 /
  atol 1e-4 and the resample indices exactly (``test_torch_step.py``'s).

The runner under torchrun and the refusals are in
``test_torch_mesh_runner.py``. The rank bodies live in
``torch_mesh_ranks.py``, which imports no JAX: a spawned rank loads only
it, torch and the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from phdslam_tpu.config import load_config as jax_load_config
from phdslam_tpu.filter.state import Measurements as JMeas
from phdslam_tpu.filter.state import SlamState as JState
from phdslam_tpu.parallel import mesh as JM
from phdslam_tpu_torch.filter.predict import noise_dim
from phdslam_tpu_torch.filter.state import SlamState

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
TOL_MAP = dict(rtol=2e-4, atol=1e-4)

STEP_CASES = {f"{kind}-{thresh}": dict(kind=kind, thresh=thresh)
              for kind in ("static", "cphd", "mixed", "fastslam", "shotgun",
                           "disparity") for thresh in (1.1, 0.0)}
STEP_CASES["scan"] = dict(kind="static", thresh=1.1, scan=True, steps=5)
STEP_CASES["disparity-scan"] = dict(kind="disparity", thresh=1.1,
                                    scan=True, steps=4)
# sharded_run_scan at 3 x 64 particles a rank (not a power of two), the
# resample always (1.1) or on some steps (0.999: steps 2-4 of 5) firing:
# the lineage crosses the ranks' blocks unevenly
UNEVEN_PER_RANK = 3 * 64
UNEVEN_CASES = {f"scan-uneven-{thresh}": dict(kind="static", thresh=thresh,
                                              scan=True, steps=5)
                for thresh in (1.1, 0.999)}
ISLAND_CASES = {f"islands{'' if n == 4 else n}-{kind}-{thresh}": dict(
    kind=kind, thresh=thresh, islands=n)
    for n in (4, 8) for kind in ("static", "cphd", "mixed")
    for thresh in (0.0, 1.1)}
# the kernel entries each kind's step reaches
KERNELS = dict(static={"preupdate", "select", "merge"},
               shotgun={"preupdate", "select", "merge"},
               cphd={"preupdate", "select", "esf", "merge"},
               mixed={"preupdate", "select", "select4", "merge", "merge4"},
               fastslam={"preupdate", "auction"}, disparity={"merge3"})
JAX_KINDS = ("static", "cphd")
JAX_W = 4


def _bits(a):
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _jax_draws(key, cfg):
    """JAX's draws for slam_step(key) (tests/test_torch_step.py): normals
    [sub, P, d], uniforms [P]."""
    k_pred, _k_var, k_res = jax.random.split(key, 3)
    sub = max(int(cfg.subdividePredict), 1)
    keys = jax.random.split(k_pred, sub)
    normals = np.stack([np.asarray(jax.random.normal(
        keys[i], (cfg.n_particles, noise_dim(cfg)), jnp.float32))
        for i in range(sub)])
    u = np.asarray(jax.random.uniform(k_res, (cfg.n_particles,),
                                      jnp.float32))
    return torch.as_tensor(normals), torch.as_tensor(np.array(u))


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's sharded_step on JAX_W virtual CPU devices over R.T_STEPS steps
    (thresh 1.1) of the cases' inputs, per kind: (final JAX state, step
    auxes, the port's case replaying the same draws)."""
    mesh = JM.make_mesh(JAX_W)
    out = {}
    for kind in JAX_KINDS:
        tcfg = R.config(kind, resampleThresh=1.1)
        path = R.KINDS[kind][0]
        jcfg = jax_load_config(path).replace(**R.KINDS[kind][1],
                                             resampleThresh=1.1)
        zs, ctrls = R.inputs(tcfg, R.T_STEPS)
        step = JM.sharded_step(jcfg, mesh)
        js = JM.shard_state(JState.create(jcfg), mesh)
        key = jax.random.PRNGKey(5)
        noises, auxs = [], []
        for t in range(R.T_STEPS):
            key, sk = jax.random.split(key)
            zj = JM.replicate_measurements(JMeas(
                rb=jnp.asarray(zs[t].rb.numpy()),
                label=jnp.asarray(zs[t].label.numpy()),
                valid=jnp.asarray(zs[t].valid.numpy())), mesh)
            js, aux = step(js, sk, (jnp.float32(ctrls[t][0]),
                                    jnp.float32(ctrls[t][1])), zj,
                           jnp.float32(jcfg.dt), jnp.asarray(t > 0))
            auxs.append(jax.device_get(aux))
            noises.append(_jax_draws(sk, tcfg))
        out[kind] = (jax.device_get(js), auxs,
                     dict(kind=kind, thresh=1.1, noises=noises,
                          z_prev=False))
    return out


def _uneven(world):
    """UNEVEN_CASES at UNEVEN_PER_RANK particles a rank of world ranks."""
    return {k: dict(v, over=dict(n_particles=UNEVEN_PER_RANK * world))
            for k, v in UNEVEN_CASES.items()}


@pytest.fixture(scope="module")
def rank_runs(jax_runs, tmp_path_factory):
    """Every case on 2 and on 4 gloo ranks: {W: rank 0's results}."""
    tmp = tmp_path_factory.mktemp("mesh")
    jobs = {2: {**STEP_CASES, **ISLAND_CASES, **_uneven(2)},
            4: {**STEP_CASES, **ISLAND_CASES, **_uneven(4),
                **{f"jax-{k}": v[2] for k, v in jax_runs.items()}}}
    return {w: R.run_ranks(job, w, tmp) for w, job in jobs.items()}


def _assert_same_bits(ref, got, tag):
    assert sorted(ref) == sorted(got), tag
    for k in ref:
        assert ref[k].shape == got[k].shape, f"{tag} {k}"
        assert ref[k].dtype == got[k].dtype, f"{tag} {k}"
        assert np.array_equal(_bits(ref[k]), _bits(got[k])), f"{tag} {k}"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(STEP_CASES))
def test_sharded_matches_single_process(rank_runs, world, name):
    """The sharded step (or scan) on W gloo ranks writes every byte the
    single process writes: each step's aux and log aux, the final state."""
    ref = R.run_case(STEP_CASES[name])
    got = rank_runs[world][name]
    _assert_same_bits(ref, got, f"{name} W={world}")
    assert any(k.endswith("resampled") or k.endswith("resample_idx")
               for k in ref)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(UNEVEN_CASES))
def test_sharded_run_scan_uneven_lineage(rank_runs, world, name):
    """sharded_run_scan at 3 x 64 particles a rank on W gloo ranks, bit for
    bit with run_scan in the single process (every step's aux and log
    values, the final state), with a lineage that is not the identity
    and that takes particles across the ranks' blocks."""
    ref = R.run_case(_uneven(world)[name])
    _assert_same_bits(ref, rank_runs[world][name], f"{name} W={world}")
    ridx = ref[".outs.1.resample_idx"]
    own = np.arange(ridx.shape[1])
    assert ridx.shape[1] == UNEVEN_PER_RANK * world
    assert (ridx != own).any()
    assert (ridx // UNEVEN_PER_RANK != own // UNEVEN_PER_RANK).any()
    resampled = ref[".outs.0.resampled"]
    assert resampled.all() if name.endswith("1.1") \
        else resampled.any() and not resampled.all()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(ISLAND_CASES))
def test_islands_across_ranks_match_one_device(rank_runs, world, name):
    """n = 4 and 8 islands on W ranks (n/W each), the butterfly forced
    (1.1) or never run (0): bit for bit the one-device island step, which
    tests/test_torch_island.py holds to JAX's shard_map step."""
    ref = R.run_case(ISLAND_CASES[name])
    _assert_same_bits(ref, rank_runs[world][name], f"{name} W={world}")
    exchanged = [v for k, v in ref.items() if k.endswith(".exchanged")]
    assert all(bool(e) == name.endswith("1.1") for e in exchanged)


@pytest.mark.parametrize("kind", JAX_KINDS)
def test_sharded_matches_jax_sharded_step(rank_runs, jax_runs, kind):
    """The port's sharded step on 4 ranks against JAX's sharded_step on 4
    devices, on JAX's draws, resample forced each step."""
    js, jauxs, _ = jax_runs[kind]
    got = rank_runs[JAX_W][f"jax-{kind}"]
    last = R.T_STEPS - 1
    for t, jaux in enumerate(jauxs):
        for name in ("expected_pose", "neff", "log_lik"):
            np.testing.assert_allclose(got[f".steps.{t}.0.{name}"],
                                       np.asarray(getattr(jaux, name)),
                                       err_msg=f"step {t} {name}", **TOL)
        assert bool(got[f".steps.{t}.0.resampled"]) == bool(jaux.resampled)
    np.testing.assert_allclose(got[".state.pose"], js.pose, **TOL)
    np.testing.assert_allclose(got[".state.log_weights"], js.log_weights,
                               **TOL)
    np.testing.assert_array_equal(got[".state.resample_idx"],
                                  js.resample_idx)
    np.testing.assert_array_equal(got[f".steps.{last}.1.resample_idx"],
                                  js.resample_idx)
    for ch in ("w", "mx", "my", "c00", "c01", "c11"):
        np.testing.assert_allclose(got[f".state.map_static.{ch}"],
                                   getattr(js.map_static, ch), err_msg=ch,
                                   **TOL_MAP)
    if kind == "cphd":
        cn, jcn = got[".state.cardinality"], np.asarray(js.cardinality)
        fin = np.isfinite(jcn)
        assert (np.isfinite(cn) == fin).all()
        np.testing.assert_allclose(cn[fin], jcn[fin], **TOL)


def _shard_bytes(kind, world):
    """(leaves of the kind's state, bytes of one rank's shard of them)."""
    leaves = []
    SlamState.create(R.config(kind)).map(lambda t: leaves.append(t) or t)
    return len(leaves), sum(t.numel() * t.element_size()
                            for t in leaves) // world


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["static", "cphd", "mixed", "fastslam"])
@pytest.mark.parametrize("thresh", [0.0, 1.1])
def test_sharded_step_moves_maps_only_when_it_resamples(rank_runs, world,
                                                        kind, thresh):
    """Each sharded step: the weights twice and the [P/W, 6] poses once
    (normalisation, nEff, expected pose), one read of the device (the
    resample's trigger); the state's leaves once, one rank's shard each,
    only when the resample fires (1.1), as under JAX's lax.cond."""
    steps = rank_runs[world]["__extras__"][f"{kind}-{thresh}"]["traffic"]
    n_leaves, shard = _shard_bytes(kind, world)
    pose_block = R.config(kind).n_particles // world * 6 * 4
    assert len(steps) == R.T_STEPS
    for t, rec in enumerate(steps):
        keys = {"gather_rows step", "read_flag resample"}
        if thresh > 1.0:
            keys.add("gather_rows resample")
        assert set(rec) == keys, (t, sorted(rec))
        assert rec["read_flag resample"]["calls"] == 1
        assert rec["gather_rows step"]["calls"] == 3
        assert rec["gather_rows step"]["largest"] == pose_block
        if thresh > 1.0:
            res = rec["gather_rows resample"]
            assert res["calls"] == n_leaves
            assert res["offered"] == shard
            assert res["received"] == shard * (world - 1)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("thresh", [0.0, 1.1])
def test_sharded_disparity_step_gathers_clouds_every_step(rank_runs, world,
                                                          thresh):
    """Each sharded disparity step: the weights and the [P/W, 12] poses
    once each (label step: normalisation, expected pose), no read of the
    device, and the pose, weights and clouds once, one rank's shard each
    (label resample), on every step whether or not the resample fires (0:
    never, 1.1: always), as JAX's ungated jnp.take of every leaf does
    (phdslam_tpu/filter/disparity.py), unlike slam_step's lax.cond."""
    from phdslam_tpu_torch.filter.disparity import DisparityState
    cfg = R.config("disparity")
    st = DisparityState.create(cfg)
    per = cfg.n_particles // world
    shard = sum(t.numel() * t.element_size()
                for t in (st.pose, st.w, st.px, st.py, st.pz)) // world
    steps = rank_runs[world]["__extras__"][f"disparity-{thresh}"]["traffic"]
    assert len(steps) == R.T_STEPS
    for t, rec in enumerate(steps):
        assert set(rec) == {"gather_rows step", "gather_rows resample"}, \
            (t, sorted(rec))
        assert rec["gather_rows step"]["calls"] == 2
        assert rec["gather_rows step"]["offered"] == per * 4 + per * 12 * 4
        res = rec["gather_rows resample"]
        assert res["calls"] == 5
        assert res["offered"] == shard
        assert res["received"] == shard * (world - 1)
        assert res["largest"] == per * cfg.maxFeatures \
            * cfg.particlesPerFeature * 4


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(ISLAND_CASES))
def test_island_step_swaps_shards_only_with_partners(rank_runs, world,
                                                     name):
    """Each island step across ranks: the [n/W] log-likelihoods and [n/W,
    6] expected poses gathered, one read of the device (the exchange's
    trigger); when it exchanges (1.1), exactly log2(W) exchange_rows calls
    of the rank's whole shard with its partner ranks and nothing
    gathered larger than [n/W, 6] floats; no transfer at all otherwise
    (tests/test_multichip_evidence.py::
    test_island_path_hlo_moves_only_shard_sized_data's counterpart)."""
    case = ISLAND_CASES[name]
    q = case["islands"] // world
    _, shard = _shard_bytes(case["kind"], world)
    rounds = world.bit_length() - 1
    steps = rank_runs[world]["__extras__"][name]["traffic"]
    assert len(steps) == R.T_STEPS
    for t, rec in enumerate(steps):
        keys = {"gather_rows island", "read_flag butterfly"}
        if case["thresh"] > 1.0:
            keys.add("exchange_rows butterfly")
        assert set(rec) == keys, (t, sorted(rec))
        assert rec["read_flag butterfly"]["calls"] == 1
        assert rec["gather_rows island"]["calls"] == 2
        assert rec["gather_rows island"]["largest"] == q * 6 * 4
        if case["thresh"] > 1.0:
            ex = rec["exchange_rows butterfly"]
            assert ex["calls"] == rounds
            assert ex["largest"] == shard
            assert ex["offered"] == ex["received"] == rounds * shard


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(STEP_CASES) + list(ISLAND_CASES))
def test_kernels_get_the_ranks_rows(rank_runs, world, name):
    """Every kernel entry on a rank receives the rank's P/W rows, never the
    global P (tests/test_multichip_evidence.py::
    test_global_path_hlo_shards_flops_and_gathers_maps's counterpart)."""
    case = {**STEP_CASES, **ISLAND_CASES}[name]
    cfg = R.config(case["kind"])
    P = cfg.n_particles * max(int(cfg.nPredictParticles), 1)
    rows = rank_runs[world]["__extras__"][name]["rows"]
    assert set(rows) == KERNELS[case["kind"]]
    assert all(v == {P // world} for v in rows.values()), rows

"""The port's public functions that no filter path calls, against the JAX
package's: ``models/motion.py`` (``cv_feature_q``, ``cv_feature_predict``,
``cp_feature_predict``, ``jump_markov_split``), ``models/measurement.py``
(``measurement_jacobian``, ``detection_probability``,
``birth_gaussian_4d``), ``ops/linalg.py`` (``det2``, ``inv2``, ``sym2``,
``symmetrize``, ``quadform``, ``mahalanobis_gaussian``,
``hellinger_gaussian``, ``gaussian_logpdf``), ``ops/gm.py``
(``top_k_components``, ``prune_weights``, ``greedy_merge``,
``greedy_merge_batch``, ``eval_mixture``) and
``filter/estimate.py::map_map_dynamic``, on float32 inputs from numpy
seeds.

Tolerances: elementwise and closed-form functions rtol 1e-5 / atol 1e-6
(float32, a few operations in another order); the general-d solves,
determinants and log-densities rtol 1e-4 / atol 1e-5 (LU in another
library); the greedy merges rtol 1e-4 / atol 1e-5 on every output (the
moments are sums over up to N components), with the picks themselves
exact (a weight compared with zero); selections and masks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.filter import estimate as JE
from phdslam_tpu.filter.state import SlamState as JState
from phdslam_tpu.models import measurement as JM
from phdslam_tpu.models import motion as JMo
from phdslam_tpu.ops import gm as JG
from phdslam_tpu.ops import linalg as JL
from phdslam_tpu_torch.bridge import state_from_numpy
from phdslam_tpu_torch.filter import estimate as TE
from phdslam_tpu_torch.models import measurement as TM
from phdslam_tpu_torch.models import motion as TMo
from phdslam_tpu_torch.ops import gm as TG
from phdslam_tpu_torch.ops import linalg as TL

torch.set_num_threads(1)

EXACT = dict(rtol=1e-5, atol=1e-6)
SOLVE = dict(rtol=1e-4, atol=1e-5)
MERGE = dict(rtol=1e-4, atol=1e-5)


def _f32(a):
    return np.asarray(a, np.float32)


def _spd(rng, shape, d, floor=0.3):
    a = rng.normal(size=shape + (d, d))
    return _f32(a @ np.swapaxes(a, -1, -2) / d + floor * np.eye(d))


def _both(fn_j, fn_t, *args, **kw):
    """fn_j on jnp arrays, fn_t on CPU tensors of the same numpy args;
    returns both results as lists of numpy arrays."""
    wrap = lambda r: [np.asarray(x) for x in
                      (r if isinstance(r, tuple) else (r,))]
    j = fn_j(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
               for a in args], **kw)
    t = fn_t(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
               for a in args], **kw)
    return wrap(j), wrap(t)


def _close(j, t, tol):
    assert len(j) == len(t)
    for a, b in zip(j, t):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, **tol)


# ------------------------------------------------------------ motion --

@pytest.mark.parametrize("dt", [0.1, 0.5])
def test_cv_feature_q(dt):
    j = np.asarray(JMo.cv_feature_q(dt, 0.3, 0.7))
    t = TMo.cv_feature_q(dt, 0.3, 0.7).numpy()
    np.testing.assert_array_equal(t, j)


def test_cv_feature_q_per_feature_variances():
    """Tensor variances give one Q per feature, each the scalar call's."""
    vx, vy = _f32([0.1, 0.4, 2.0]), _f32([0.3, 0.05, 1.0])
    t = TMo.cv_feature_q(0.5, torch.as_tensor(vx), torch.as_tensor(vy))
    assert t.shape == (3, 4, 4)
    for i in range(3):
        np.testing.assert_allclose(
            t[i].numpy(), np.asarray(JMo.cv_feature_q(
                0.5, float(vx[i]), float(vy[i]))), **EXACT)


@pytest.mark.parametrize("scales", [(1.0, 1.0), (0.3, 2.5)])
def test_cv_feature_predict(tiny_cfg, scales):
    rng = np.random.default_rng(1)
    mean = _f32(rng.normal(size=(5, 7, 4)))
    cov = _spd(rng, (5, 7), 4)
    j, t = _both(lambda m, c: JMo.cv_feature_predict(m, c, tiny_cfg, 0.5,
                                                      *scales),
                 lambda m, c: TMo.cv_feature_predict(m, c, tiny_cfg, 0.5,
                                                      *scales), mean, cov)
    _close(j, t, EXACT)


def test_cp_feature_predict(tiny_cfg):
    rng = np.random.default_rng(2)
    mean = _f32(rng.normal(size=(6, 2)))
    cov = _spd(rng, (6,), 2)
    j, t = _both(lambda m, c: JMo.cp_feature_predict(m, c, tiny_cfg, 0.25),
                 lambda m, c: TMo.cp_feature_predict(m, c, tiny_cfg, 0.25),
                 mean, cov)
    _close(j, t, EXACT)


@pytest.mark.parametrize("feature_model", [1, 2])
def test_jump_markov_split(tiny_cfg, feature_model):
    rng = np.random.default_rng(3)
    w = _f32(rng.uniform(0, 1, (4, 9)))
    mean = _f32(rng.normal(scale=1.5, size=(4, 9, 4)))
    j, t = _both(lambda a, m: JMo.jump_markov_split(a, m, tiny_cfg,
                                                     feature_model),
                 lambda a, m: TMo.jump_markov_split(a, m, tiny_cfg,
                                                     feature_model), w, mean)
    _close(j, t, EXACT)


# ------------------------------------------------------- measurement --

def test_measurement_jacobian():
    rng = np.random.default_rng(4)
    dx, dy = _f32(rng.normal(size=(3, 8))), _f32(rng.normal(size=(3, 8)))
    r2 = _f32(dx * dx + dy * dy)
    r = _f32(np.sqrt(r2))
    j, t = _both(JM.measurement_jacobian, TM.measurement_jacobian, dx, dy,
                 r, r2)
    _close(j, t, EXACT)


def test_detection_probability(tiny_cfg):
    rng = np.random.default_rng(5)
    r = _f32(rng.uniform(0, 1.5 * tiny_cfg.maxRange, (6, 20)))
    b = _f32(rng.uniform(-2.0, 2.0, (6, 20)))
    j, t = _both(lambda a, c: JM.detection_probability(a, c, tiny_cfg),
                 lambda a, c: TM.detection_probability(a, c, tiny_cfg), r, b)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[0].dtype == np.float32
    assert 0 < (t[0] > 0).mean() < 1


def test_birth_gaussian_4d(tiny_cfg):
    rng = np.random.default_rng(6)
    pose = _f32(np.concatenate([rng.normal(size=(5, 3)),
                                np.zeros((5, 3))], 1))
    z = _f32(np.stack([rng.uniform(-0.5, 10, 5), rng.uniform(-1, 1, 5)], 1))
    j, t = _both(lambda p, zz: JM.birth_gaussian_4d(p, zz, tiny_cfg),
                 lambda p, zz: TM.birth_gaussian_4d(p, zz, tiny_cfg),
                 pose[:, None], z[None])
    _close(j, t, EXACT)


# ------------------------------------------------------------ linalg --

def test_2x2_algebra():
    rng = np.random.default_rng(7)
    m = _f32(rng.normal(size=(4, 6, 2, 2)))
    x = _f32(rng.normal(size=(4, 6, 2)))
    for fn in ("det2", "inv2", "sym2", "symmetrize"):
        j, t = _both(getattr(JL, fn), getattr(TL, fn), m)
        _close(j, t, EXACT)
    det = _f32(rng.uniform(0.5, 2.0, (4, 6)))
    j, t = _both(JL.inv2, TL.inv2, m, det)
    _close(j, t, EXACT)
    j, t = _both(JL.quadform, TL.quadform, x, m)
    _close(j, t, EXACT)


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("fn", ["mahalanobis_gaussian",
                                "hellinger_gaussian"])
def test_gaussian_distances(d, fn):
    rng = np.random.default_rng(8 + d)
    ma, mb = (_f32(rng.normal(size=(5, 7, d))) for _ in range(2))
    ca, cb = _spd(rng, (5, 7), d), _spd(rng, (5, 7), d)
    j, t = _both(getattr(JL, fn), getattr(TL, fn), ma, ca, mb, cb)
    _close(j, t, EXACT if d == 2 and fn == "mahalanobis_gaussian"
           else SOLVE)


@pytest.mark.parametrize("d", [2, 3])
def test_gaussian_logpdf(d):
    rng = np.random.default_rng(20 + d)
    x, m = (_f32(rng.normal(size=(6, d))) for _ in range(2))
    c = _spd(rng, (6,), d)
    j, t = _both(JL.gaussian_logpdf, TL.gaussian_logpdf, x, m, c)
    _close(j, t, EXACT if d == 2 else SOLVE)


# ---------------------------------------------------------------- gm --

def _mixture(seed, lead, n, d, n_empty=3, ties=False):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.05, 1.0, lead + (n,))
    if ties:
        w = np.round(w * 4) / 4 + 0.25
    w[..., n - n_empty:] = 0.0
    mean = rng.uniform(-3, 3, lead + (n, d))
    return _f32(w), _f32(mean), _spd(rng, lead + (n,), d)


@pytest.mark.parametrize("ties", [False, True])
def test_top_k_components(ties):
    w, mean, cov = _mixture(30, (4,), 12, 2, ties=ties)
    j, t = _both(lambda a, b, c: JG.top_k_components(a, b, c, 5),
                 lambda a, b, c: TG.top_k_components(a, b, c, 5), w, mean,
                 cov)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b, a)


def test_prune_weights():
    w, _, _ = _mixture(31, (3,), 10, 2)
    j, t = _both(JG.prune_weights, TG.prune_weights, w, 0.4)
    np.testing.assert_array_equal(t[0], j[0])


@pytest.mark.parametrize("d", [2, 3])
def test_eval_mixture(d):
    w, mean, cov = _mixture(32 + d, (3,), 8, d)
    x = _f32(np.random.default_rng(40).uniform(-3, 3, (3, 5, d)))
    j = np.asarray(JG.eval_mixture(jnp.asarray(w)[:, None],
                                   jnp.asarray(mean)[:, None],
                                   jnp.asarray(cov)[:, None],
                                   jnp.asarray(x)))
    t = TG.eval_mixture(torch.as_tensor(w)[:, None],
                        torch.as_tensor(mean)[:, None],
                        torch.as_tensor(cov)[:, None],
                        torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(t, j, **(EXACT if d == 2 else SOLVE))


MERGES = [(2, 0, 4.0), (2, 1, 0.6), (3, 0, 4.0), (4, 0, 5.0)]


@pytest.mark.parametrize("d,metric,sep", MERGES)
def test_greedy_merge(d, metric, sep):
    """The array-of-structs merge with leading dims [2, 3] against JAX's
    unbatched greedy_merge vmapped, at a cap that some mixtures reach and
    with slots left over in others."""
    w, mean, cov = _mixture(50 + d + metric, (2, 3), 14, d)
    cap = 9
    jfn = jax.vmap(jax.vmap(lambda a, b, c: JG.greedy_merge(
        a, b, c, sep, cap, metric)))
    j = [np.asarray(x) for x in jfn(jnp.asarray(w), jnp.asarray(mean),
                                    jnp.asarray(cov))]
    t = [x.numpy() for x in TG.greedy_merge(
        torch.as_tensor(w), torch.as_tensor(mean), torch.as_tensor(cov), sep,
        cap, metric)]
    np.testing.assert_array_equal(t[0] > 0, j[0] > 0)
    assert (j[0] > 0).sum(-1).min() < cap      # rows that ran out early
    _close(j, t, MERGE)


@pytest.mark.parametrize("d,metric,sep", MERGES)
def test_greedy_merge_batch(d, metric, sep):
    """The batched merge against JAX's: d = 2 (its greedy_merge_batch, the
    channel core) through the merge kernel's plain version; d = 3 through
    merge3's against JAX's channel core greedy_merge_channels3 (its XLA
    path) in matrix form; d = 4 through greedy_merge against JAX's
    greedy_merge vmapped."""
    w, mean, cov = _mixture(60 + d + metric, (6,), 16, d)
    cap = 10
    jw, jm, jc = jnp.asarray(w), jnp.asarray(mean), jnp.asarray(cov)
    if d == 2:
        j = JG.greedy_merge_batch(jw, jm, jc, sep, cap, metric)
    elif d == 3:
        sym = lambda a, b: 0.5 * (jc[..., a, b] + jc[..., b, a])
        o = JG.greedy_merge_channels3(
            jw, jm[..., 0], jm[..., 1], jm[..., 2], jc[..., 0, 0], sym(0, 1),
            sym(0, 2), jc[..., 1, 1], sym(1, 2), jc[..., 2, 2], sep, cap,
            use_pallas=False)
        c = [[o[4], o[5], o[6]], [o[5], o[7], o[8]], [o[6], o[8], o[9]]]
        j = (o[0], jnp.stack(o[1:4], -1),
             jnp.stack([jnp.stack(r, -1) for r in c], -2))
    else:
        j = jax.vmap(lambda a, b, c: JG.greedy_merge(a, b, c, sep, cap,
                                                     metric))(jw, jm, jc)
    j = [np.asarray(x) for x in j]
    t = [x.numpy() for x in TG.greedy_merge_batch(
        torch.as_tensor(w), torch.as_tensor(mean), torch.as_tensor(cov), sep,
        cap, metric)]
    np.testing.assert_array_equal(t[0] > 0, j[0] > 0)
    _close(j, t, MERGE)


def test_greedy_merge_batch_routes_to_the_kernels(monkeypatch):
    """d = 2 and 3 go through the merge and merge3 wrappers (the kernels on
    CUDA tensors), leading dims flattened; d = 4 through neither."""
    from phdslam_tpu_torch.kernels import _build
    seen = []
    real = _build.kernel_for

    def spy(device, cuda_fn, plain_fn, name):
        seen.append(name)
        return real(device, cuda_fn, plain_fn, name)

    monkeypatch.setattr(_build, "kernel_for", spy)
    for d in (2, 3, 4):
        w, mean, cov = _mixture(70 + d, (2, 3), 8, d)
        out = TG.greedy_merge_batch(torch.as_tensor(w),
                                    torch.as_tensor(mean),
                                    torch.as_tensor(cov), 4.0, 5)
        assert out[0].shape == (2, 3, 5) and out[2].shape == (2, 3, 5, d, d)
    assert seen == ["merge", "merge3"]


# ---------------------------------------------------------- estimate --

def test_map_map_dynamic(tiny_cfg):
    cfg = tiny_cfg.replace(featureModel=2)
    rng = np.random.default_rng(80)
    js = jax.device_get(JState.create(cfg))
    P, F = js.map_dynamic.w.shape
    js = js.replace(
        log_weights=_f32(np.log(rng.dirichlet(np.ones(P)))),
        map_dynamic=js.map_dynamic.replace(
            w=_f32(rng.uniform(0, 1, (P, F))),
            mean_channels=_f32(rng.normal(size=(P, 4, F))),
            cov_channels=_f32(rng.uniform(0.1, 1, (P, 10, F)))))
    j = jax.device_get(JE.map_map_dynamic(js))
    t = TE.map_map_dynamic(state_from_numpy(js))
    for k in ("w", "mean_channels", "cov_channels"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), getattr(j, k))

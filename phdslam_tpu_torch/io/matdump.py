"""Full particle-state export to MATLAB .mat files.

The port's copy of ``phdslam_tpu/io/matdump.py`` (NumPy and ``scipy.io``;
held equal by ``tests/test_torch_host.py``). ``state`` is a host view
with the JAX ``SlamState``'s attributes (``bridge.host_view``).

Equivalent of writeParticlesMat (src/main.cpp:594-713, via matio): one
``particlesXXXXX.mat`` per step containing a scalar struct ``particles``
with exactly the reference's ten fields (src/main.cpp:694-713):

  states          6 x N double        (px py ptheta vx vy vtheta columns)
  weights         1 x N double        (log particle weights)
  vars            1 x N double
  maps_static     1 x N struct array  (weights 1xF, means 2xF, covs 2x2xF)
  maps_dynamic    1 x N struct array  (weights 1xF, means 4xF, covs 4x4xF)
  resample_idx    1 x N int32
  max_map_static  1 x 1 struct        (filled when mapEstimate & 1)
  max_map_dynamic 1 x 1 struct
  exp_map_static  1 x 1 struct        (filled when mapEstimate & 2)
  exp_map_dynamic 1 x 1 struct

The per-particle mixtures use write_map_mat's dims (src/main.cpp:503-556):
weights 1 x map_size, means dims x map_size, covs dims x dims x map_size
(column-major cov slices, matching the Gaussian2D/4D cov[] layout of
src/slamtypes.h). This is the layout matlab/computeBatchResults.m:44-66
indexes as ``particles.maps_static(idx_max).weights`` and
matlab/computeExpectedMap.m consumes.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import savemat

_MIX_DTYPE = np.dtype([("weights", object), ("means", object),
                       ("covs", object)])


def _fill_mixture(rec, w, mean, cov):
    """Fill one struct-array element with a (possibly empty) mixture."""
    d = mean.shape[-1] if mean.ndim else 0
    sel = np.asarray(w) > 0
    f = int(sel.sum())
    rec["weights"] = np.asarray(w)[sel].astype(np.float64).reshape(1, f)
    rec["means"] = np.asarray(mean)[sel].T.astype(np.float64).reshape(d, f)
    # covs: MATLAB covs(:,:,j) must equal the j-th covariance matrix
    rec["covs"] = np.ascontiguousarray(
        np.asarray(cov)[sel].transpose(1, 2, 0).astype(np.float64)
    ).reshape(d, d, f)


def _mixture_struct_array(w, mean, cov):
    """[n, F] mixture arrays -> (1, n) MATLAB struct array."""
    n = w.shape[0]
    arr = np.empty((1, n), dtype=_MIX_DTYPE)
    for p in range(n):
        _fill_mixture(arr[0, p], w[p], mean[p], cov[p])
    return arr


def _single_map_struct(gm, dims):
    """Optional (w, mean, cov) tuple -> 1x1 struct (empty if None),
    mirroring the unfilled Mat_VarCreateStruct when the mapEstimate bit is
    off (src/main.cpp:665-692)."""
    arr = np.empty((1, 1), dtype=_MIX_DTYPE)
    if gm is None:
        _fill_mixture(arr[0, 0], np.zeros(0), np.zeros((0, dims)),
                      np.zeros((0, dims, dims)))
    else:
        w, mean, cov = (np.asarray(a) for a in gm)
        _fill_mixture(arr[0, 0], w, mean, cov)
    return arr


def write_particles_mat(directory: str, t: int, state, prefix="particles",
                        max_map_static=None, max_map_dynamic=None,
                        exp_map_static=None, exp_map_dynamic=None):
    """state: SlamState (host or device). Writes <prefix>XXXXX.mat.

    The four optional map-estimate arguments are (weights, means, covs)
    tuples for the MAP / EAP merged maps (recoverSlamState outputs)."""
    poses = np.asarray(state.pose)                   # [P, 6]
    n = poses.shape[0]

    d2 = np.asarray(state.map_static.w)
    dyn = state.map_dynamic.max_features > 0
    if dyn:
        dw = np.asarray(state.map_dynamic.w)
        dm = np.asarray(state.map_dynamic.mean)
        dc = np.asarray(state.map_dynamic.cov)
    else:
        dw = np.zeros((n, 0))
        dm = np.zeros((n, 0, 4))
        dc = np.zeros((n, 0, 4, 4))

    particles = dict(
        states=poses.T.astype(np.float64),           # 6 x N, like matio
        weights=np.asarray(state.log_weights, np.float64).reshape(1, n),
        vars=np.asarray(state.variances, np.float64).reshape(1, n),
        maps_static=_mixture_struct_array(
            d2, np.asarray(state.map_static.mean),
            np.asarray(state.map_static.cov)),
        maps_dynamic=_mixture_struct_array(dw, dm, dc),
        resample_idx=np.asarray(state.resample_idx,
                                np.int32).reshape(1, n),
        max_map_static=_single_map_struct(max_map_static, 2),
        max_map_dynamic=_single_map_struct(max_map_dynamic, 4),
        exp_map_static=_single_map_struct(exp_map_static, 2),
        exp_map_dynamic=_single_map_struct(exp_map_dynamic, 4),
    )
    path = os.path.join(directory, f"{prefix}{t:05d}.mat")
    savemat(path, {"particles": particles}, do_compression=True)
    return path


def _read_mixture_struct(ms):
    """(1, n) loaded struct array -> dict of per-particle lists."""
    flat = ms.ravel()
    return dict(
        weights=[np.asarray(e["weights"]).ravel() for e in flat],
        means=[np.asarray(e["means"]) for e in flat],
        covs=[np.asarray(e["covs"]) for e in flat],
    )


def read_particles_mat(path: str):
    """Parse a particlesXXXXX.mat back into plain numpy structures
    (matlab/parseParticleFile.m / computeBatchResults.m equivalent)."""
    from scipy.io import loadmat

    d = loadmat(path, squeeze_me=False)
    p = d["particles"][0, 0]
    # 'vars' is the current (matio-matched) field name; fall back to
    # 'variances' for .mat files written by the pre-round-4 exporter.
    var_field = "vars" if "vars" in p.dtype.names else "variances"
    out = dict(
        states=np.asarray(p["states"]),
        weights=np.asarray(p["weights"]).ravel(),
        variances=np.asarray(p[var_field]).ravel(),
        resample_idx=np.asarray(p["resample_idx"]).ravel().astype(int),
    )
    for key in ("maps_static", "maps_dynamic", "max_map_static",
                "max_map_dynamic", "exp_map_static", "exp_map_dynamic"):
        if key in p.dtype.names:
            out[key] = _read_mixture_struct(p[key])
    return out

"""The port's camera geometry (``models/camera.py``) against
``phdslam_tpu.models.camera`` on the same seeded inputs, with the shipped
disparity calibration read by each package's own loader.

Tolerance: rtol 1e-5 / atol 1e-4 on world and camera coordinates (float32
trigonometry and products of metre-scale values), rtol 2e-5 / atol 1e-3 on
pixels and disparities (values in the hundreds, divided by a depth), the
visibility masks exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.config import load_config as jax_load_config
from phdslam_tpu.models import camera as JC
from phdslam_tpu_torch import load_config
from phdslam_tpu_torch.models import camera as TC

torch.set_num_threads(1)

CFG = "cfg/disparity_synth.cfg"
TOL_XYZ = dict(rtol=1e-5, atol=1e-4)
TOL_PIX = dict(rtol=2e-5, atol=1e-3)


@pytest.fixture(scope="module")
def cfgs():
    return jax_load_config(CFG), load_config(CFG)


def _poses(rng, n):
    pose = rng.normal(0, 0.5, (n, 12)).astype(np.float32)
    pose[:, 3:6] = rng.uniform(-np.pi, np.pi, (n, 3))
    return pose


def _pts(rng, n):
    return rng.normal(0, 4, (n, 3)).astype(np.float32)


def test_camera_world_transforms_match_jax(rng):
    pose, pts = _poses(rng, 16), _pts(rng, 16)
    for is_point in (True, False):
        for jf, tf in ((JC.world_to_camera, TC.world_to_camera),
                       (JC.camera_to_world, TC.camera_to_world)):
            ref = jf(*(jnp.asarray(pts[:, i]) for i in range(3)),
                     jnp.asarray(pose), is_point=is_point)
            got = tf(*(torch.as_tensor(pts[:, i]) for i in range(3)),
                     torch.as_tensor(pose), is_point=is_point)
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           **TOL_XYZ)


def test_disparity_transforms_match_jax(rng, cfgs):
    jcfg, tcfg = cfgs
    pose = _poses(rng, 64) * 0.1
    # points in front of the camera (d = -fx / zc > 0) and a few behind it
    pts = np.stack([rng.uniform(-3, 3, 64), rng.uniform(-2, 2, 64),
                    rng.uniform(-2, 9, 64)], 1).astype(np.float32)
    pts[0, 2] = pose[0, 2]                 # zc near 0: the 1e-12 guard
    ref = JC.world_to_disparity(*(jnp.asarray(pts[:, i]) for i in range(3)),
                                jnp.asarray(pose), jcfg)
    got = TC.world_to_disparity(*(torch.as_tensor(pts[:, i])
                                  for i in range(3)),
                                torch.as_tensor(pose), tcfg)
    fin = np.isfinite(np.asarray(ref[0]))
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy()[fin], np.asarray(r)[fin],
                                   **TOL_PIX)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert got[3].any() and not got[3].all()

    uvd = np.stack([rng.uniform(1, 799, 32), rng.uniform(1, 599, 32),
                    rng.uniform(50, 300, 32)], 1).astype(np.float32)
    uvd[0, 2] = 0.0                        # d = 0: the 1e-12 guard
    pose = pose[:32]
    ref = JC.disparity_to_world(*(jnp.asarray(uvd[:, i]) for i in range(3)),
                                jnp.asarray(pose), jcfg)
    got = TC.disparity_to_world(*(torch.as_tensor(uvd[:, i])
                                  for i in range(3)),
                                torch.as_tensor(pose), tcfg)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy()[1:], np.asarray(r)[1:],
                                   **TOL_XYZ)
        np.testing.assert_allclose(g.numpy()[0], np.asarray(r)[0], rtol=1e-5)


def test_camera_cv_predict_matches_jax(rng, cfgs):
    jcfg, tcfg = cfgs
    pose = _poses(rng, 32)
    pose[:4, 3:6] = 3.1                    # angles that wrap
    noise = rng.normal(0, 0.01, (32, 6)).astype(np.float32)
    for dt in (1.0, 0.1):
        ref = JC.camera_cv_predict(jnp.asarray(pose), jnp.asarray(noise),
                                   jcfg, dt)
        got = TC.camera_cv_predict(torch.as_tensor(pose),
                                   torch.as_tensor(noise), tcfg, dt)
        assert got.shape == (32, 12)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL_XYZ)

"""The port imports without JAX: in a fresh interpreter, import the package
and every module of it, then check that neither jax nor flax was loaded and
that no loaded module comes from a file of the JAX package (``phdslam_tpu/``),
which would catch a module loaded from there by path. Nothing is built: no
nvcc, triton or CUDA is needed."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import phdslam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    phdslam_tpu_torch.__path__, "phdslam_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import os, torch
jax_pkg = os.path.join(os.path.abspath("phdslam_tpu"), "")
print(json.dumps(dict(
    modules=names,
    from_jax_pkg=sorted(
        n for n, m in list(sys.modules.items())
        if os.path.abspath(getattr(m, "__file__", None) or "").startswith(
            jax_pkg)),
    jax_pkg_modules=sorted(m for m in sys.modules
                           if m.split(".")[0] == "phdslam_tpu"),
    jax=sorted(m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax")),
    tf32=[torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32],
    built="phdslam_tpu_torch.kernels._build" in sys.modules
          and sys.modules["phdslam_tpu_torch.kernels._build"]
          .library.cache_info().currsize)))
"""


def test_import_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax"] == []
    assert out["from_jax_pkg"] == [] and out["jax_pkg_modules"] == []
    expected = {"phdslam_tpu_torch." + m for m in (
        "bridge", "runner", "config", "simdata", "io.loaders", "io.logs",
        "filter.state", "filter.predict", "filter.update", "filter.update4",
        "filter.step", "filter.estimate", "filter.cphd", "filter.disparity",
        "ops.linalg", "ops.gm", "ops.resample", "models.measurement",
        "models.motion", "models.camera", "kernels.select",
        "kernels.select4", "kernels.merge", "kernels.merge4",
        "kernels.merge3", "kernels.esf", "kernels._build")}
    assert expected <= set(out["modules"])
    assert "phdslam_tpu_torch._shared" not in out["modules"]
    assert out["tf32"] == [False, False]
    assert not out["built"]          # importing builds no kernel

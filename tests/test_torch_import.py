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
    loaded_top=sorted({m.split(".")[0] for m in sys.modules}),
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
        "kernels.merge3", "kernels.esf", "kernels._build",
        "kernels.sweep", "kernels.auction", "filter.fastslam", "ops.jcbb",
        "ops.ospa", "io.matdump", "eval.player", "checkpoint", "eval.batch",
        "eval.plots", "parallel", "parallel.island", "parallel.mesh",
        "filter.runs", "reference_cpu", "reference_cpu_disparity", "bench",
        "stage_profile")}
    assert expected <= set(out["modules"])
    assert "phdslam_tpu_torch._shared" not in out["modules"]
    assert "matplotlib" not in out["loaded_top"]   # the player's, lazily
    assert out["tf32"] == [False, False]
    assert not out["built"]          # importing builds no kernel


RANK_PROBE = r"""
import json, sys, tempfile
sys.path.insert(0, "tests")
import torch_mesh_ranks as R
if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as d:
        res = R.run_ranks({"static": dict(kind="static", thresh=1.1)}, 2, d)
    print(json.dumps(dict(rank=res["__reference_modules__"],
                          parent=R.loaded_reference_modules(),
                          keys=len(res["static"]))))
"""


def test_rank_process_loads_no_jax(tmp_path):
    """A gloo rank of the mesh (``tests/torch_mesh_ranks.py``, spawned two
    at a time, one sharded step each) loads neither JAX nor any module of
    ``phdslam_tpu/``, by name or by file; nor does the process that
    spawns them."""
    env = dict(os.environ, PYTHONWARNINGS="ignore")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    probe = tmp_path / "probe.py"
    probe.write_text(RANK_PROBE)
    proc = subprocess.run([sys.executable, str(probe)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["rank"] == [] and out["parent"] == []
    assert out["keys"] > 0

"""No module of the benchmark imports JAX, flax or the JAX package, and the
reference's modules import nothing of the program; a CPU run of the
harness loads none of them. Top-level names are compared whole: the
port's name, phdslam_tpu_torch, begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
REPO = BENCH.parent
BANNED = {"jax", "jaxlib", "flax", "phdslam_tpu"}
#: the yardstick: it may not lean on the program it judges
REFERENCE = ("reference.py", "judge.py", "scene.py", "counts.py",
             "trace.py")


def top_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not top_imports(f) & BANNED, f


def test_the_reference_imports_nothing_of_the_program():
    for name in REFERENCE:
        assert "phdslam_tpu_torch" not in top_imports(BENCH / name), name


def test_a_cpu_run_loads_none_of_them():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, run\n"
        "cell = harness.load_cell('dense8k.clutter40')\n"
        "cell.cfg.update(n_particles=16, max_features=8, "
        "max_measurements=8)\n"
        "run.run_cell(cell, 1, 0.2, False, 'cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "phdslam_tpu_torch" in loaded
    assert not loaded & BANNED

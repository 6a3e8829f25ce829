"""Build and load the package's CUDA kernels.

Every ``phdslam_tpu_torch/csrc/*.cu`` file has a plain C interface, so the
kernels compile with ``nvcc`` alone (no PyTorch headers, seconds instead of
minutes) into one shared library that ``ctypes`` loads. The library goes to
``build/phdslam_tpu_torch/<hash>/`` at the repository root, keyed by a hash
of the sources and flags, so an edited source rebuilds and an unchanged one
is reused. Nothing is built at import: the first kernel launch calls
``library()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "phdslam_tpu_torch"
# nvcc's default multiply-add contraction stays on: it moves the kernels'
# results by ulps against the plain versions, which no tolerance notices
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: name -> argtypes (restype is int, the cudaError_t of the
# launch). Pointers and the stream are c_void_p: an int argument would be
# cut to 32 bits.
SIGNATURES = {
    "phd_select_launch": [_P] * 16 + [_P, _P] + [_P] * 9
    + [_I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _P],
    "phd_merge_launch": [_P] * 6 + [_P] * 6
    + [_I, _I, _I, _F, _I, _P],
    "phd_error_string": [_I],
}


class BuildError(RuntimeError):
    """nvcc failed or is missing; the message carries its output."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library():
    """Build (if needed) and load the kernel library. Returns
    ``(ctypes.CDLL, info)`` where info holds the path, whether this call
    compiled, the build seconds and nvcc's output."""
    srcs = sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    so = out_dir / "libphdslam_tpu_torch.so"
    info = dict(path=str(so), built=False, seconds=0.0, log="")
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build under a temporary name, then rename: a concurrent loader
        # never sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise BuildError(f"nvcc failed ({proc.returncode}): "
                             f"{' '.join(cmd)}\n{info['log']}")
        os.replace(tmp, so)
        info.update(built=True, seconds=time.perf_counter() - t0)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_char_p if name == "phd_error_string" \
            else ctypes.c_int
    return lib, info


def check(lib, err: int, what: str):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.phd_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

"""Build and load the package's CUDA kernels.

Every ``phdslam_tpu_torch/csrc/*.cu`` file has a plain C interface (the
``*.cuh`` headers hold device code they share), so the kernels compile with
``nvcc`` alone (no PyTorch headers, seconds instead of minutes) into one
shared library that ``ctypes`` loads. The library goes to
``build/phdslam_tpu_torch/<hash>/`` at the repository root, keyed by a hash
of the sources and flags, so an edited source rebuilds and an unchanged one
is reused. Nothing is built at import: the first kernel launch calls
``library()``. The checks every kernel wrapper makes live here too.
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "phdslam_tpu_torch"
# nvcc's default multiply-add contraction stays on: it moves the kernels'
# results by ulps against the plain versions, which no tolerance notices
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: name -> argtypes (restype is int, the cudaError_t of the
# launch). Pointers and the stream are c_void_p: an int argument would be
# cut to 32 bits.
SIGNATURES = {
    "phd_select_launch": [_P] * 16 + [_P, _P] + [_P] * 10
    + [_I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _I, _P, _P],
    "phd_select4_launch": [_P] * 10 + [_P] + [_P] * 5
    + [_I, _I, _I, _I, _I, _I, _P, _P],
    "phd_select_wide_floats": [_I, _I],
    "phd_merge_launch": [_P] * 6 + [_P] * 6
    + [_I, _I, _I, _F, _I, _P, _P, _P],
    "phd_merge4_launch": [_P] * 3 + [_P] * 3 + [_I, _I, _I, _F, _P, _P],
    "phd_merge3_launch": [_P] * 10 + [_P] * 10 + [_I, _I, _I, _F, _P, _P],
    "phd_merge_wide_floats": [_I, _I],
    "phd_merge4_wide_floats": [_I, _I],
    "phd_merge3_wide_floats": [_I, _I],
    "phd_esf_launch": [_P] * 3 + [_I, _I, _P],
    "phd_select_ctas_per_sm": [_I, _P],
    "phd_select4_ctas_per_sm": [_I, _P],
    "phd_merge_ctas_per_sm": [_I],
    "phd_merge4_ctas_per_sm": [_I],
    "phd_merge3_ctas_per_sm": [_I, _P],
    "phd_esf_ctas_per_sm": [_I, _I, _P],
    "phd_esf_log1p_mismatches": [],
    "phd_merge4_reject_scale": [_P, _P, _I, _P],
    "phd_auction_launch": [_P] * 3 + [_I] * 3 + [_F, _I, _P, _P],
    "phd_auction_wide_floats": [_I, _I, _I],
    "phd_auction_path": [_I, _I],
    "phd_auction_ctas_per_sm": [_I, _I, _P],
    "phd_auction_square_launch": [_P] * 4 + [_I] * 4 + [_P, _P],
    "phd_auction_square_wide_floats": [_I, _I],
    "phd_auction_square_path": [_I],
    "phd_auction_square_ctas_per_sm": [_I, _P],
    "phd_preupdate_launch": [_P] * 7 + [_I, _P, _P, _I, _I] + [_F] * 12
    + [_P],
    "phd_error_string": [_I],
}
# every other function returns an int
RESTYPES = {"phd_error_string": ctypes.c_char_p,
            "phd_select_wide_floats": ctypes.c_longlong,
            "phd_merge_wide_floats": ctypes.c_longlong,
            "phd_merge4_wide_floats": ctypes.c_longlong,
            "phd_merge3_wide_floats": ctypes.c_longlong,
            "phd_auction_wide_floats": ctypes.c_longlong,
            "phd_auction_square_wide_floats": ctypes.c_longlong,
            "phd_esf_log1p_mismatches": ctypes.c_longlong}


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
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands side by side, wait for all of them, and raise if
    one failed; returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise BuildError(f"nvcc failed ({p.returncode}): "
                             f"{' '.join(c)}\n{out}")
    return "".join(outs)


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
        # build in a private directory, then rename the library into place:
        # a concurrent loader never sees a half-written one
        with tempfile.TemporaryDirectory(dir=out_dir) as work:
            nvcc = _nvcc()
            # one nvcc per source, all started together, then one link
            objs = [os.path.join(work, f"{s.stem}.o") for s in srcs]
            log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                            for s, o in zip(srcs, objs)])
            tmp = os.path.join(work, so.name)
            log += _run_all([[nvcc, *ARCH, "-shared", "-o", tmp, *objs]])
            info["log"] = log
            os.replace(tmp, so)
        info.update(built=True, seconds=time.perf_counter() - t0)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib, info


def check_tensor(t, shape, device, name):
    """Raise unless t is a contiguous float32 tensor of this shape on this
    device."""
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous float32 {tuple(shape)} on {device},"
            f" got {t.dtype} {tuple(t.shape)} on {t.device}")


def kernel_for(device, cuda_fn, plain_fn, what: str):
    """The kernel on a CUDA device, its plain version on the CPU."""
    if device.type == "cuda":
        return cuda_fn
    if device.type == "cpu":
        return plain_fn
    raise ValueError(f"no {what} kernel for device {device}")


def scratch(n: int, device):
    """n floats of device memory for a kernel's wide path (a select row
    above 1024 slots, a merge pool past a CTA's shared memory; n from the
    kernel's ``phd_*_wide_floats``), or None where n is 0."""
    if n == 0:
        return None
    return torch.empty((n,), dtype=torch.float32, device=device)


def ptr(t):
    """A tensor's device pointer, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def check(lib, err: int, what: str):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.phd_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

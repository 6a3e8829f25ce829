"""Rebuild the select, merge3, esf and auction kernels with other constants
or small source edits and time each variant on the card: the sweep behind
the choice of ``kRowRegs``, ``kWarps`` (``csrc/select_common.cuh``),
merge3's ``kThreads`` / ``kBatch`` (``csrc/merge3.cu``) and esf's
``kGroup`` and ``kLaneThreads`` (``csrc/esf.cu``), with a few diagnostic
builds that show where the select loop's, the esf kernel's and the
auctions' time goes ("auction prologue only": FastSLAM's association
stops after its prologue pass, so the rest is the rounds and the readout;
"square empty rounds": no row of the square auction bids, so every phase
runs its budget of rounds that do nothing but synchronise, the cost of a
round without bidders).

    python3 -m phdslam_tpu_torch.kernels.sweep [NAME ...]

Run from the root of a checkout on a machine with a CUDA GPU and nvcc; the
inputs are ``chip_smoke.py``'s seeded dense ones (8192 x 512 x 64 for the
selects, a [8192, 560] -> 128 pool at min_sep 4 for merge3, log Lambda
[1024, 64] for esf, FastSLAM's raw benefit at [8192, 64, 512] and [256,
64, 128], the OSPA costs of 8 set pairs at n = 16, 64 and 256). Each
variant copies ``csrc/`` to a temporary
directory, applies its edits, builds it with ``kernels/_build.py`` and
prints one line: registers and CTAs per SM, the times (CUDA events) of
select normalised at k1 = 8, 1 and 31, raw at k1 = 8, by index and at F =
128 (8192 x 128 x 64), of select4, merge3, esf and esf at the shipped
[256, 64], esf's kernels' device times apart (torch.profiler), esf's
largest difference from ``esf_all_plain``, the floats in [0, inf) where
the kernels' ``log1p_nonneg`` differs from ``log1pf``, and whether its
outputs equal the first variant's bit for bit (the diagnostic variants
compute something else and say so). With no NAME every variant runs.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import re
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from phdslam_tpu_torch.kernels import _build
from phdslam_tpu_torch.kernels import auction as A
from phdslam_tpu_torch.kernels import esf as E
from phdslam_tpu_torch.kernels import merge3 as G3
from phdslam_tpu_torch.kernels import select as S
from phdslam_tpu_torch.kernels import select4 as S4
from phdslam_tpu_torch.ops import ospa as O

_HEADER = "select_common.cuh"
_SHUFFLES = """// The per-launch constants of the loop.""", """\
__device__ __forceinline__ unsigned warp_max(unsigned x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
// The per-launch constants of the loop."""

_ESF_LAE = "mx + log1p_nonneg(expf(mn - mx))"
_ESF_FILLS = "fills_card(four.kernel, 4LL * P * M)"
_ESF_KERNEL = re.compile(r"esf_\w+")
_PROLOGUE = "    int it = 0;\n    if (budget > 0 && M > 0) {\n"
_SQUARE_BID = "if (s.assigned[m]) continue;\n          const float* row"
_SQUARE_NO_BID = "if (true) continue;\n          const float* row"
_SQUARE_REG_BID = "if (m >= n || s.assigned[m])"

#: name -> (edits (file, old text, new text), what the variant is)
VARIANTS = {
    "shipped": ([], "the sources as they are"),
    "G = 1": ([(_HEADER, "kRowRegs = 16;", "kRowRegs = 1;")],
              "one measurement a sweep at every F"),
    "rows 32": ([(_HEADER, "kRowRegs = 16;", "kRowRegs = 32;")],
                "G = 2 at F = 512"),
    "rows 64": ([(_HEADER, "kRowRegs = 16;", "kRowRegs = 64;")],
                "G = 4 at F = 512"),
    "4 warps": ([(_HEADER, "kWarps = 8;", "kWarps = 4;")], "kWarps = 4"),
    "6 CTAs": ([(f, "__launch_bounds__(kWarps * 32)",
                 "__launch_bounds__(kWarps * 32, 6)")
                for f in ("select.cu", "select4.cu")],
               "registers capped for 6 CTAs per SM"),
    "shuffles": ([(_HEADER, *_SHUFFLES),
                  (_HEADER, "__reduce_max_sync(kFull, ", "warp_max("),
                  (_HEADER, "__reduce_min_sync(kFull, ", "warp_min(")],
                 "shuffle butterflies for the warp reductions"),
    "merge3 batch 2": ([("merge3.cu", "kBatch = 4;", "kBatch = 2;")], ""),
    "merge3 batch 8": ([("merge3.cu", "kBatch = 4;", "kBatch = 8;")], ""),
    "merge3 64 threads": ([("merge3.cu", "kThreads = 128;",
                            "kThreads = 64;")], ""),
    "merge3 256 threads": ([("merge3.cu", "kThreads = 128;",
                             "kThreads = 256;")], ""),
    "staging only": ([("select.cu", "in.si11, in.lds);\n",
                       "in.si11, in.lds);\n  if (a.k1 == 31) return;\n")],
                     "diagnostic: k1 = 31 returns after staging"),
    "__expf": ([(_HEADER, "expf(base - 0.5f * d2)",
                 "__expf(base - 0.5f * d2)")], "diagnostic: not exact"),
    "no wrap": ([(_HEADER, "wrap_round(zb[g] - b)", "(zb[g] - b)")],
                "diagnostic: not exact"),
    "esf 4 threads a lane": ([("esf.cu", _ESF_FILLS, "true")],
                             "at every P"),
    "esf 8 threads a lane": ([("esf.cu", _ESF_FILLS, "false")],
                             "at every P"),
    "esf 16 threads a lane": ([("esf.cu", _ESF_FILLS, "false"),
                               ("esf.cu", "lanes_in_registers<8, 32>",
                                "lanes_in_registers<16, 32>")],
                              "at every P"),
    "esf 32-thread CTAs": ([("esf.cu", "kLaneThreads = 128;",
                             "kLaneThreads = 32;")], ""),
    "esf 64-thread CTAs": ([("esf.cu", "kLaneThreads = 128;",
                             "kLaneThreads = 64;")], ""),
    "esf 256-thread CTAs": ([("esf.cu", "kLaneThreads = 128;",
                              "kLaneThreads = 256;")], ""),
    "esf library log1pf": ([("esf.cu", _ESF_LAE,
                             "mx + log1pf(expf(mn - mx))")],
                           "the library call, its special-input branch"),
    "esf MUFU": ([("esf.cu", _ESF_LAE,
                   "mx + __logf(1.0f + __expf(mn - mx))")],
                 "base-2 MUFU ex2.approx and lg2.approx, not exact"),
    "esf no math": ([("esf.cu", _ESF_LAE, "mx")],
                    "diagnostic: logaddexp is the max"),
    "auction prologue only": ([("auction.cu", _PROLOGUE,
                                "    if (budget > 0) continue;\n"
                                + _PROLOGUE)],
                              "diagnostic: no rounds, no readout"),
    "square empty rounds": ([("auction.cu", _SQUARE_BID, _SQUARE_NO_BID),
                             ("auction.cu", _SQUARE_REG_BID, "if (true)")],
                            "diagnostic: no row bids"),
}


@contextlib.contextmanager
def variant_library(edits, work: Path):
    """Build the kernels from a copy of csrc/ with the edits applied and
    make the wrappers launch from it while the context is open."""
    src = work / "csrc"
    shutil.copytree(_build.CSRC, src)
    for name, old, new in edits:
        f = src / name
        text = f.read_text()
        if old not in text:
            raise ValueError(f"{name} has no {old!r}: the edit is stale")
        f.write_text(text.replace(old, new))
    saved = _build.CSRC, _build.BUILD_ROOT
    _build.CSRC, _build.BUILD_ROOT = src, work / "build"
    _build.library.cache_clear()
    try:
        yield _build.library()[0]
    finally:
        _build.CSRC, _build.BUILD_ROOT = saved
        _build.library.cache_clear()


def occupancy(lib):
    regs = ctypes.c_int(0)
    out = []
    for fn, size in ((lib.phd_select_ctas_per_sm, 512),
                     (lib.phd_select4_ctas_per_sm, 512),
                     (lib.phd_merge3_ctas_per_sm, 560),
                     (lambda M, r: lib.phd_esf_ctas_per_sm(1024, M, r),
                      64)):
        ctas = fn(size, ctypes.byref(regs))
        out.append(f"{regs.value} registers / {ctas} CTAs")
    return ", ".join(out)


def esf_split(fn, reps=20):
    """Device time per call of each kernel fn launches (torch.profiler), as
    "name ms" pairs: the esf launch's two kernels apart."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return ", ".join(
        f"{_ESF_KERNEL.search(e.key).group(0)} "
        f"{e.device_time_total / reps / 1e3:.4f} ms"
        for e in prof.key_averages() if "esf_" in e.key)


def main(argv=None):
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as C

    names = (argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    dev = torch.device("cuda", 0)
    print(C.gpu_line(), flush=True)
    P, F, M = C.DENSE["P"], C.DENSE["F"], C.DENSE["M"]
    cfg, pre, gm, z = C.random_select_inputs(P, F, M, 2, dev)
    chans, kw, nv = C._select_args(S, cfg, pre, gm, z, dict(
        raw=False, with_compat=True, with_lpw=True, nv=None))
    kwb = dict(kw, by_index=True)
    pre4, gm4, z4 = C.random_select4_inputs(P, F, M, 22, dev)
    loop, gain, mean, cov = S4.select4_channels(pre4, gm4)
    loop = [c.contiguous() for c in loop]
    pool = C.random_pool3(8192, 560, 40, dev)
    cfg1, pre1, gm1, z1 = C.random_select_inputs(P, C.SHIPPED["F"], M, 3,
                                                 dev)
    chans1, kw1, nv1 = C._select_args(S, cfg1, pre1, gm1, z1, dict(
        raw=False, with_compat=True, with_lpw=True, nv=None))
    ll = torch.as_tensor(np.random.default_rng(50).normal(
        -1.0, 2.0, (C.DENSE_CPHD["P"], C.DENSE_CPHD["M"])).astype(np.float32),
        device=dev)
    esf_plain = E.esf_all_plain(ll)
    runs = {
        "select": lambda: S.select_cuda(chans, z, nv, **kw),
        "k1 = 1": lambda: S.select_cuda(chans, z, nv, **dict(kw, k1=1)),
        "k1 = 31": lambda: S.select_cuda(chans, z, nv, **dict(kw, k1=31)),
        "raw": lambda: S.select_cuda(chans, z, nv, **dict(kw, raw=True)),
        "by index": lambda: S.select_cuda(chans[:S.N_LOOP], z, nv, **kwb),
        "F = 128": lambda: S.select_cuda(chans1, z1, nv1, **kw1),
        "select4": lambda: S4.select4_cuda(loop, gain, mean, cov, z4, k1=8),
        "merge3": lambda: G3.merge3_cuda(*pool, 4.0, 128),
        "esf": lambda: E.esf_all_cuda(ll),
        "esf P = 256": lambda: E.esf_all_cuda(ll[:256]),
    }
    for i, (Pa, Ma, Fa, kind) in enumerate(C.AUCTION_CASES[:2]):
        ben, pv, budget = C.random_auction_inputs(Pa, Ma, Fa, 80 + i, dev,
                                                  kind)
        runs[f"auction [{Pa}, {Ma}, {Fa}]"] = functools.partial(
            A.auction_assign_cuda, ben, pv, budget)
    eps = O.eps_schedule(dev)
    for n in C.OSPA_SIZES:
        cost = torch.stack([O.padded_cost(*C.ospa_sets(n, s, dev)[4],
                                          C.OSPA_P, C.OSPA_C)[1]
                            for s in range(C.OSPA_SEEDS)]).contiguous()
        runs[f"square n = {n}"] = functools.partial(
            A.auction_square_cuda, cost, eps, O._BIDS_PER_N * n)
    first = None
    for name in names:
        edits, what = VARIANTS[name]
        with tempfile.TemporaryDirectory() as d, \
                variant_library(edits, Path(d)) as lib:
            outs = {k: fn() for k, fn in runs.items()}
            torch.cuda.synchronize()
            first = first or outs
            same = all(torch.equal(a, b) for k in outs
                       for a, b in zip(outs[k], first[k]))
            ms = {k: C.cuda_ms(fn, 5 if k == "merge3" else 10)
                  for k, fn in runs.items()}
            # the square auction's rounds: per problem over its phases
            per_round = "; ".join(
                f"{k} {ms[k] * 1e3 / float(outs[k][1].sum(1).float().mean()):.3f}"
                f" us a round (mean {float(outs[k][1].sum(1).float().mean()):.1f}"
                f" rounds a problem)" for k in runs if k.startswith("square"))
            live = [p > -1e29 for p in esf_plain]
            esf_err = max(float((k - p)[m].abs().max())
                          for k, p, m in zip(outs["esf"], esf_plain, live))
            print(f"{name} ({what or 'constants'}): {occupancy(lib)}; "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                  + f"; esf on the device: {esf_split(runs['esf'])}"
                  + f"; esf max abs difference from plain {esf_err:.3e}"
                  + "; log1p_nonneg / log1pf mismatches on [0, inf) "
                  f"{lib.phd_esf_log1p_mismatches()}"
                  + f"; {per_round}"
                  + f"; outputs as the first variant's: {same}", flush=True)


if __name__ == "__main__":
    main()

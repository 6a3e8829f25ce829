"""Rebuild the select, merge, merge3, esf and auction kernels with other
constants or small source edits and time each variant on the card: the
sweep behind the choice of ``kRowRegs``, ``kWarps``
(``csrc/select_common.cuh``), merge3's ``kThreads`` / ``kBatch``
(``csrc/merge3.cu``) and esf's ``kGroup`` and ``kLaneThreads``
(``csrc/esf.cu``), with a few diagnostic builds that show where the select
loop's, the merge's, the esf kernel's and the auctions' time goes ("merge
after stage": the merge stops after the presort and the staging loads;
"merge before moments": after the pick chain, so the rest is the moments;
"auction prologue only": FastSLAM's association stops after its prologue
pass, so the rest is the rounds and the readout; "square empty rounds": no
row of the square auction bids, so every phase runs its budget of rounds
that do nothing but synchronise, the cost of a round without bidders).

    python3 -m phdslam_tpu_torch.kernels.sweep [NAME ...]
    python3 -m phdslam_tpu_torch.kernels.sweep --merge-only [NAME ...]
    python3 -m phdslam_tpu_torch.kernels.sweep --csrc DIR --merge-only \
        [NAME ...]
    python3 -m phdslam_tpu_torch.kernels.sweep --against DIR

Run from the root of a checkout on a machine with a CUDA GPU and nvcc; the
inputs are ``chip_smoke.py``'s seeded dense ones (8192 x 512 x 64 for the
selects, tests/merge_pools.py's course pools at the benchmark cells' merge
shapes, [8192, 1088] -> 512 and [65536, 704] -> 128 at min_sep 5, for the
merge, a [8192, 560] -> 128 pool at min_sep 4 for merge3, log Lambda
[1024, 64] for esf, FastSLAM's raw benefit at [8192, 64, 512] and [256,
64, 128], the OSPA costs of 8 set pairs at n = 16, 64 and 256).
``--merge-only`` times the merge runs alone; ``--csrc DIR`` takes the
sources from another checkout's ``csrc/`` (bound by that checkout's own
``kernels/_build.py`` signatures), so that a diagnostic build of an older
merge times alike. ``--against DIR`` holds the merge kernel bit for bit
against DIR's build on every case of chip_smoke.py's merge phase, on pools
with NaN and infinite candidates, at both ends of the gated chain's shared
memory and past a CTA's, times both builds on each, and exits non-zero on
a difference. Each
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
import importlib.util
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
# merge.cu's merge_particle (alike before and after the gated resolution):
# where the chain starts and where the moments start; a diagnostic stop
# writes one value a particle so that nothing before it is dead code
_MERGE_TEST = "  Near<kMetric> test{s_mx, s_my, s_c00, s_c01, s_c11, min_sep};"
_MERGE_STAGED = ("  if (threadIdx.x == 0)\n"
                 "    out.w[static_cast<size_t>(p) * cap] = s_c11[0];\n"
                 "  if (K > 0) return;\n")
_MERGE_MOMENTS = "  Moments acc{s_w,   s_mx,  s_my, s_c00,"
_MERGE_CHAINED = ("  if (threadIdx.x == 0)\n"
                  "    out.w[static_cast<size_t>(p) * cap] = n;\n"
                  "  if (K > 0) return;\n")
_MERGE_SHAPES = (("dense8k", 8192, 1088, 512), ("wide65k", 65536, 704, 128))

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
    "merge after stage": ([("merge.cu", _MERGE_TEST, _MERGE_STAGED
                             + _MERGE_TEST)],
                          "diagnostic: presort and staging loads only"),
    "merge before moments": ([("merge.cu", _MERGE_MOMENTS, _MERGE_CHAINED
                               + _MERGE_MOMENTS)],
                             "diagnostic: no moments"),
    "auction prologue only": ([("auction.cu", _PROLOGUE,
                                "    if (budget > 0) continue;\n"
                                + _PROLOGUE)],
                              "diagnostic: no rounds, no readout"),
    "square empty rounds": ([("auction.cu", _SQUARE_BID, _SQUARE_NO_BID),
                             ("auction.cu", _SQUARE_REG_BID, "if (true)")],
                            "diagnostic: no row bids"),
}


@contextlib.contextmanager
def variant_library(edits, work: Path, csrc: Path = None):
    """Build the kernels from a copy of csrc/ (or csrc) with the edits
    applied and make the wrappers launch from it while the context is
    open."""
    src = work / "csrc"
    shutil.copytree(csrc or _build.CSRC, src)
    for name, old, new in edits:
        f = src / name
        text = f.read_text()
        if old not in text:
            raise ValueError(f"{name} has no {old!r}: the edit is stale")
        f.write_text(text.replace(old, new))
    if csrc is not None:
        yield merge_library(src, csrc)
        return
    saved = _build.CSRC, _build.BUILD_ROOT
    _build.CSRC, _build.BUILD_ROOT = src, work / "build"
    _build.library.cache_clear()
    try:
        yield _build.library()[0]
    finally:
        _build.CSRC, _build.BUILD_ROOT = saved
        _build.library.cache_clear()


def merge_library(src: Path, tree: Path):
    """merge.cu of the sources in src alone, built and loaded, bound by the
    signatures of tree's checkout (tree its csrc/; its
    ``kernels/_build.py``): an older launch takes no stats pointer."""
    so = src.parent / "libmerge.so"
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                      str(so), str(src / "merge.cu")]])
    spec = importlib.util.spec_from_file_location(
        "_tree_build", tree.parent / "kernels" / "_build.py")
    theirs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(theirs)
    lib = ctypes.CDLL(str(so))
    for name in ("phd_merge_launch", "phd_merge_wide_floats",
                 "phd_merge_ctas_per_sm"):
        fn = getattr(lib, name)
        fn.argtypes = theirs.SIGNATURES[name]
        fn.restype = theirs.RESTYPES.get(name, ctypes.c_int)
    lib.with_stats = (len(theirs.SIGNATURES["phd_merge_launch"])
                      == len(_build.SIGNATURES["phd_merge_launch"]))
    return lib


def merge_with(lib, pool, sep, cap, metric):
    """The merge kernel of lib (merge_library's) on pool."""
    P, K = pool[0].shape
    dev = pool[0].device
    outs = [torch.empty((P, cap), dtype=torch.float32, device=dev)
            for _ in range(6)]
    scratch = _build.scratch(lib.phd_merge_wide_floats(P, K), dev)
    err = lib.phd_merge_launch(
        *(c.data_ptr() for c in pool), *(o.data_ptr() for o in outs), P, K,
        cap, float(sep), int(metric), _build.ptr(scratch),
        *([None] if lib.with_stats else []),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"merge: CUDA error {err}")
    return outs


def merge_pools(C, dev):
    """Course pools at the cells' merge shapes: name -> (pool, cap)."""
    return {f"merge {name}": (C.merge_pool("course", P, K, 7, dev), cap)
            for name, P, K, cap in _MERGE_SHAPES}


def merge_runs(pools, merge):
    """name -> the merge of that pool at min_sep 5."""
    return {k: functools.partial(merge, pool, 5.0, cap, 0)
            for k, (pool, cap) in pools.items()}


def against(C, other: Path):
    """Hold the merge kernel bit for bit against the build of other (a
    csrc directory) on chip_smoke.py's merge cases, on pools at both ends
    of the gated chain's shared memory (K 7609 and 7610) and past a CTA's
    (K > 7744), and time both builds on each (CUDA events); returns the
    cases that differ."""
    from phdslam_tpu_torch.kernels import merge as G
    dev = torch.device("cuda", 0)
    cases = list(C.merge_cases(dev)) + [
        (kind, C.merge_pool(kind, 260, K, 90 + i, dev), (sep, cap, metric))
        for i, (kind, K, cap, metric, sep) in enumerate((
            ("outliers", 1088, 512, 0, 5.0), ("outliers", 1088, 512, 1, 0.6),
            ("random", 7609, 256, 0, 5.0), ("random", 7610, 256, 0, 5.0),
            ("random", 7744, 256, 0, 5.0), ("random", 7745, 256, 0, 5.0),
            ("course", 8192, 300, 0, 5.0), ("course", 16384, 300, 0, 5.0),
            ("outliers", 7745, 300, 1, 0.6)))]
    bad = []
    with tempfile.TemporaryDirectory() as d, \
            variant_library([], Path(d), other) as lib:
        for kind, pool, (sep, cap, metric) in cases:
            P, K = pool[0].shape
            mine = G.merge_cuda(*pool, sep, cap, metric)
            theirs = merge_with(lib, pool, sep, cap, metric)
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(mine, theirs))
            what = f"merge [{P}, {K}] -> {cap} metric {metric} ({kind})"
            ms = C.cuda_ms(lambda: G.merge_cuda(*pool, sep, cap, metric), 5)
            ms_other = C.cuda_ms(lambda: merge_with(lib, pool, sep, cap,
                                                    metric), 5)
            print(f"{what}: bit for bit as {other}'s build: {same}; "
                  f"{ms:.4f} ms (that build {ms_other:.4f})", flush=True)
            if not same:
                bad.append(what)
    return bad


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


def merge_sweep(C, names, csrc):
    """--merge-only: each variant's merge at the cells' shapes."""
    from phdslam_tpu_torch.kernels import merge as G
    pools = merge_pools(C, torch.device("cuda", 0))
    first = None
    for name in names:
        edits, what = VARIANTS[name]
        with tempfile.TemporaryDirectory() as d, \
                variant_library(edits, Path(d), csrc) as lib:
            runs = merge_runs(pools, (lambda pool, *a: G.merge_cuda(*pool, *a))
                              if csrc is None else
                              functools.partial(merge_with, lib))
            outs = {k: fn() for k, fn in runs.items()}
            torch.cuda.synchronize()
            first = first or outs
            same = all(torch.equal(a, b) for k in outs
                       for a, b in zip(outs[k], first[k]))
            ms = {k: C.cuda_ms(fn, 10) for k, fn in runs.items()}
            print(f"{name} ({what or 'constants'}), sources "
                  f"{csrc or _build.CSRC}: merge "
                  f"{lib.phd_merge_ctas_per_sm(1088)} CTAs per SM at K = "
                  f"1088, {lib.phd_merge_ctas_per_sm(704)} at 704; "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                  + f"; outputs as the first variant's: {same}", flush=True)


def main(argv=None):
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as C

    args = list(argv if argv is not None else sys.argv[1:])
    csrc = other = None
    merge_only = "--merge-only" in args
    if merge_only:
        args.remove("--merge-only")
    for flag in ("--csrc", "--against"):
        if flag in args:
            i = args.index(flag)
            path = Path(args[i + 1]).resolve()
            del args[i:i + 2]
            csrc, other = (path, other) if flag == "--csrc" else (csrc, path)
    from phdslam_tpu_torch.bench import gpu_line
    print(gpu_line(), flush=True)
    if other is not None:
        bad = against(C, other)
        if bad:
            raise SystemExit(f"the merge differs from {other}'s build on "
                             f"{len(bad)} cases: {bad}")
        return
    names = args or list(VARIANTS)
    if merge_only or csrc is not None:
        merge_sweep(C, names, csrc)
        return
    dev = torch.device("cuda", 0)
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

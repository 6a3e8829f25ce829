// Fused likelihood / normaliser / top-k1 selection of the GM-PHD update of
// the 2-D static map, hand-written for Hopper (sm_90a).
//
// Replaces two TPU kernels of phdslam_tpu/kernels/preupdate_pallas.py:
//   fused_update_select (Pallas bodies _kernel and _kernel_ft, the same
//     outputs in two TPU layouts): the picks with their payload;
//   fused_update_select_by_index (body _kernel_by_index): the same picks as
//     (weight, index), by_index = 1 here, for a caller that gathers the
//     payload itself.
//
// What it computes, for particle p and measurement m < n_valid, over the
// particle's F map slots f:
//   ir = z_r - r_f;  ib = wrap(z_b - b_f)      (wrap: x - 2pi*rint(x/2pi))
//   d2 = max(ir^2 si00 + 2 ir ib si01 + ib^2 si11, 0)
//   e_f = exp(lpw_f - log 2pi - lds_f / 2 - d2 / 2)
//   sum[p,m] = sum_f e_f;  compat[p,m] = any_f(in range && d2 < gate)
//   w_f = e_f / (sum + clutter + birth), pruned below min_weight (raw: e_f)
// then the k1 largest w_f (lowest f on ties) and, by_index = 0, their
// payload: the updated mean mx + K innov, the updated covariance (u00, u01,
// u11) and lpw; by_index = 1, their index f (0 where w = 0). Columns
// m >= n_valid are zeros.
//
// What bounds it on an H100: P*M*F (p, m, f) triples, each with one expf
// and about thirty other instructions (only the live slots' need them: a
// dead slot's term is 0), and k1 argmax rounds per (p, m) row. At the
// dense shape (8192 x 64 x 512) that is 2.7e8 triples of instruction-bound
// ALU/FMA/SFU work; the inputs are 16 [P, F] channels read once (7 in the
// by-index mode). The [P, M, F] likelihood tensor (1 GiB per float32
// channel at that shape) never reaches device memory.
//
// Design (select_common.cuh): one CTA per particle; the live slots' seven
// loop channels compacted into shared memory once, in slot order; a warp
// sweeps them for G measurements at a time with each lane's share of the
// rows in registers, normalises and prunes there, and picks with argmax
// rounds on the lanes' heads (two warp reductions a round) after a
// prefilter at the k1-th largest head, with an exact early exit once the
// best remaining value is 0. Lane j keeps round j's winner, so the payload
// of all k1 winners is read from device memory in parallel at the end.
// expf (not __expf) keeps the kernel within ulps of the plain PyTorch
// version. What changed in the sums: lane l now adds the live positions
// c = l + 32 i of the compacted row (the first design: the slots l + 32 i,
// dead ones included), so each lane's share of a row, and the rounding of
// its sum, differ from the first design's within float32 rounding. F <=
// 1024 takes at most 32 KB of shared memory; 40 registers and 6 CTAs per
// SM at F = 512. A wider row runs select_wide_kernel (select_common.cuh,
// sweep_wide): the row's values in device-memory scratch, so F is bounded
// by device memory alone.

#include <cuda_runtime.h>

#include "select_common.cuh"

namespace {

using namespace phd_select;

struct Channels {
  const float *r, *b, *lpw, *si00, *si01, *si11, *lds, *mx, *my, *g00, *g01,
      *g10, *g11, *u00, *u01, *u11;
};

struct Outputs {
  float *sum, *w, *mx, *my, *u00, *u01, *u11, *lpw;
  int* idx;
  unsigned char* compat;
};

// The zero columns m >= nv of particle p, split over the warps.
__device__ __forceinline__ void zero_columns(const Outputs& out, int p, int M,
                                             int nv, int k1, int by_index,
                                             int warp, int lane) {
  for (int m = nv + warp; m < M; m += kWarps) {
    const size_t pm = static_cast<size_t>(p) * M + m;
    const size_t sel = pm * k1;
    if (lane < k1) {
      out.w[sel + lane] = 0.f;
      if (by_index) {
        out.idx[sel + lane] = 0;
      } else {
        out.mx[sel + lane] = 0.f;
        out.my[sel + lane] = 0.f;
        out.u00[sel + lane] = 0.f;
        out.u01[sel + lane] = 0.f;
        out.u11[sel + lane] = 0.f;
        out.lpw[sel + lane] = 0.f;
      }
    }
    if (lane == 0) {
      out.sum[pm] = 0.f;
      out.compat[pm] = 0;
    }
  }
}

// Row (p, m)'s outputs: lane j < k1 writes pick j (value v, slot f) and its
// payload or index, lane 0 the sum and the gate flag.
__device__ __forceinline__ void write_row(const Channels& in,
                                          const float* __restrict__ z,
                                          const Outputs& out, int p, int M,
                                          int m, size_t off, int lane,
                                          const Loop& a, float v, int f,
                                          float sum, bool hit, int with_lpw,
                                          int by_index) {
  const int k1 = a.k1;
  const size_t pm = static_cast<size_t>(p) * M + m;
  const size_t sel = pm * k1;
  if (lane < k1) {
    const bool alive = v > 0.0f;
    out.w[sel + lane] = alive ? v : 0.0f;
    if (by_index) {
      out.idx[sel + lane] = alive ? f : 0;
    } else {
      const size_t gi = off + f;
      const float ir = z[2 * m] - in.r[off + f];
      const float ib = wrap_round(z[2 * m + 1] - in.b[off + f]);
      out.mx[sel + lane] = in.mx[gi] + in.g00[gi] * ir + in.g01[gi] * ib;
      out.my[sel + lane] = in.my[gi] + in.g10[gi] * ir + in.g11[gi] * ib;
      out.u00[sel + lane] = in.u00[gi];
      out.u01[sel + lane] = in.u01[gi];
      out.u11[sel + lane] = in.u11[gi];
      out.lpw[sel + lane] = with_lpw ? in.lpw[gi] : 0.0f;
    }
  }
  if (lane == 0) {
    out.sum[pm] = sum;
    out.compat[pm] = (a.with_compat && hit) ? 1 : 0;
  }
}

template <int kSlots>
__global__ void __launch_bounds__(kWarps * 32)
    select_kernel(Channels in, const float* __restrict__ z,
                  const int* __restrict__ n_valid, Outputs out, int M,
                  Loop a, int with_lpw, int by_index) {
  constexpr int G = group<kSlots>();
  extern __shared__ float smem[];
  const int F = a.F;
  const int p = blockIdx.x;
  const size_t off = static_cast<size_t>(p) * F;
  const Staged s = stage(smem, F, off, in.r, in.b, in.lpw, in.si00, in.si01,
                         in.si11, in.lds);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nv = max(min(*n_valid, M), 0);
  zero_columns(out, p, M, nv, a.k1, by_index, warp, lane);

  for (int m0 = warp * G; m0 < nv; m0 += kWarps * G) {
    const int n = min(G, nv - m0);
    float sum[G], pv[G];
    bool hit[G];
    int pc[G];
    sweep<kSlots, G>(s, a, lane, z, m0, n, sum, hit, pv, pc);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= n) break;
      const int f = pc[g] < 0 ? 0 : s.slot[pc[g]];
      write_row(in, z, out, p, M, m0 + g, off, lane, a, pv[g], f, sum[g],
                hit[g], with_lpw, by_index);
    }
  }
}

// Rows wider than the register rows (F > 1024): sweep_wide, one
// measurement per warp, the row in scratch (kWarps rows of F floats per
// CTA); the CTAs stride over the particles.
__global__ void __launch_bounds__(kWarps * 32)
    select_wide_kernel(Channels in, const float* __restrict__ z,
                       const int* __restrict__ n_valid, Outputs out, int P,
                       int M, Loop a, int with_lpw, int by_index,
                       float* __restrict__ scratch) {
  const int F = a.F;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row =
      scratch + (static_cast<size_t>(blockIdx.x) * kWarps + warp) * F;
  const int nv = max(min(*n_valid, M), 0);
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const size_t off = static_cast<size_t>(p) * F;
    zero_columns(out, p, M, nv, a.k1, by_index, warp, lane);
    const Row rw{in.r + off,    in.b + off,    in.lpw + off, in.si00 + off,
                 in.si01 + off, in.si11 + off, in.lds + off};
    for (int m = warp; m < nv; m += kWarps) {
      float sum, pv;
      bool hit;
      int pc;
      sweep_wide(rw, a, lane, z[2 * m], z[2 * m + 1], row, sum, hit, pv, pc);
      write_row(in, z, out, p, M, m, off, lane, a, pv, pc < 0 ? 0 : pc, sum,
                hit, with_lpw, by_index);
    }
  }
}

template <int kSlots>
cudaError_t launch(int P, size_t smem, cudaStream_t stream, Channels in,
                   const float* z, const int* n_valid, Outputs out, int M,
                   Loop a, int with_lpw, int by_index) {
  select_kernel<kSlots><<<P, kWarps * 32, smem, stream>>>(
      in, z, n_valid, out, M, a, with_lpw, by_index);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(int, size_t, cudaStream_t, Channels,
                               const float*, const int*, Outputs, int, Loop,
                               int, int);
using Kernel = void (*)(Channels, const float*, const int*, Outputs, int,
                        Loop, int, int);

}  // namespace

extern "C" {

const char* phd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Channels are [P, F] row-major float32; z is [M, 2]; n_valid points to one
// int32 on the device. Outputs: sum [P, M], w [P, M, k1], compat [P, M] as
// bytes, and either the six payload channels [P, M, k1] (mx, my, u00, u01,
// u11, lpw; by_index = 0) or idx [P, M, k1] int32 (by_index = 1). The
// pointers a mode does not use may be null: by_index = 1 reads only the
// first seven channels. scratch: phd_select_wide_floats(P, F) floats of
// device memory (null when that is 0). Returns the launch's cudaError_t.
int phd_select_launch(const float* r, const float* b, const float* lpw,
                      const float* si00, const float* si01,
                      const float* si11, const float* lds, const float* mx,
                      const float* my, const float* g00, const float* g01,
                      const float* g10, const float* g11, const float* u00,
                      const float* u01, const float* u11, const float* z,
                      const int* n_valid, float* sum_out, float* w_out,
                      float* mx_out, float* my_out, float* u00_out,
                      float* u01_out, float* u11_out, float* lpw_out,
                      int* idx_out, unsigned char* compat_out, int P, int F,
                      int M, int k1, float clutter_birth, float min_weight,
                      float gate, int raw, int with_compat, int with_lpw,
                      int by_index, float* scratch, void* stream) {
  if (P <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  if (F <= 0 || k1 <= 0 || k1 > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch go =
      for_slots<Launch>(F, launch<1>, launch<2>, launch<4>, launch<8>,
                        launch<16>, launch<32>);
  if (go == nullptr && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Channels in{r,   b,   lpw, si00, si01, si11, lds, mx,
              my,  g00, g01, g10,  g11,  u00,  u01, u11};
  Outputs out{sum_out, w_out,   mx_out,  my_out,  u00_out,
              u01_out, u11_out, lpw_out, idx_out, compat_out};
  const Loop a{F, k1, clutter_birth, min_weight, gate, raw != 0,
               with_compat != 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (go != nullptr)
    return static_cast<int>(go(P, smem_bytes(F), st, in, z, n_valid, out, M,
                               a, with_lpw, by_index));
  select_wide_kernel<<<wide_ctas(P), kWarps * 32, 0, st>>>(
      in, z, n_valid, out, P, M, a, with_lpw, by_index, scratch);
  return static_cast<int>(cudaGetLastError());
}

// Floats of device-memory scratch a launch for P particles and F slots
// (select or select4) takes: 0 where a register row holds F (F <= 1024),
// else a row of F for each warp of the wide-row kernel's grid.
long long phd_select_wide_floats(int P, int F) {
  if (P <= 0 || F <= 0 || slots_for(F) != 0) return 0;
  return static_cast<long long>(wide_ctas(P)) * kWarps * F;
}

// CTAs of the kernel for F slots that fit on one SM, and its registers per
// thread in *regs (the wide-row kernel's above 1024 slots); 0 when F < 1.
int phd_select_ctas_per_sm(int F, int* regs) {
  if (F <= 0) return 0;
  const Kernel k = for_slots<Kernel>(F, select_kernel<1>, select_kernel<2>,
                                     select_kernel<4>, select_kernel<8>,
                                     select_kernel<16>, select_kernel<32>);
  return k != nullptr ? ctas_per_sm(k, smem_bytes(F), regs)
                      : ctas_per_sm(select_wide_kernel, 0, regs);
}

}  // extern "C"

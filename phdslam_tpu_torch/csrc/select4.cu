// Raw likelihood / normaliser / top-k1 selection of the GM-PHD update of the
// 4-D dynamic map (the mixed static + dynamic model), hand-written for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of phdslam_tpu/kernels/preupdate_pallas.py:
//   fused_update_select4 (Pallas body _kernel4): the picks with their
//     payload, the 4 updated means and the 10 updated covariances;
//   fused_update_select4_by_index (body _kernel4_by_index): the same picks
//     as (weight, index), by_index = 1 here.
//
// What it computes, for particle p and every measurement m (the TPU kernel
// has no n_valid and no normalised mode; the caller masks the columns),
// over the particle's F slots f: e_f as in select.cu (same seven loop
// channels), sum[p, m] = sum_f e_f, then the k1 largest e_f (lowest f on
// ties). by_index = 0 writes their payload,
//   mean_i = m_i + g_{2i} ir + g_{2i+1} ib   (i = 0..3, from the gain rows)
//   cov_c  = cov_update_c                    (c = 0..9, the S4 order),
// in the JAX layouts mean [P, 4, M, k1] and cov [P, 10, M, k1];
// by_index = 1 writes idx [P, M, k1] (0 where w = 0).
//
// What bounds it on an H100: as select.cu, P*M*F (p, m, f) triples of
// expf and a dozen flops; the payload is 14 [P, F] channels read only at the
// k1 winners, so the bytes are the 29 [P, F] inputs (7 by index) and the
// 1 + 15 k1 output values per (p, m).
//
// Design: select.cu's loop (select_common.cuh): one CTA per particle, the
// live slots' loop channels compacted in shared memory, G measurements per
// warp sweep with the rows in registers, argmax rounds on the lanes'
// heads after the prefilter, the exact early exit (raw values: a row ends
// early only once every remaining e is 0, underflowed or dead); lane j
// fetches round j's payload from device memory, as before. 40 registers
// and 6 CTAs per SM at F = 512. Rows above 1024 slots run
// select4_wide_kernel (sweep_wide), bounded by device memory alone.

#include <cuda_runtime.h>

#include "select_common.cuh"

namespace {

using namespace phd_select;

struct Channels4 {
  const float *r, *b, *lpw, *si00, *si01, *si11, *lds;
  const float *gain, *mean, *cov;   // [P, 8, F], [P, 4, F], [P, 10, F]
};

struct Outputs4 {
  float *sum, *w, *mean, *cov;      // [P, M], [P, M, k1], [P, 4, M, k1],
  int* idx;                         // [P, 10, M, k1]; idx [P, M, k1]
};

// Row (p, m)'s outputs: lane j < k1 writes pick j (value v, slot f) and its
// payload or index, lane 0 the sum.
__device__ __forceinline__ void write_row4(const Channels4& in,
                                           const float* __restrict__ z,
                                           const Outputs4& out, int p, int F,
                                           int M, int m, size_t off, int lane,
                                           int k1, float v, int f, float sum,
                                           int by_index) {
  const size_t mk = static_cast<size_t>(M) * k1;
  const size_t pm = static_cast<size_t>(p) * M + m;
  if (lane < k1) {
    const bool alive = v > 0.0f;
    out.w[pm * k1 + lane] = alive ? v : 0.0f;
    if (by_index) {
      out.idx[pm * k1 + lane] = alive ? f : 0;
    } else {
      const float ir = z[2 * m] - in.r[off + f];
      const float ib = wrap_round(z[2 * m + 1] - in.b[off + f]);
      const size_t at = static_cast<size_t>(m) * k1 + lane;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float g0 =
            in.gain[(static_cast<size_t>(p) * 8 + 2 * i) * F + f];
        const float g1 =
            in.gain[(static_cast<size_t>(p) * 8 + 2 * i + 1) * F + f];
        const float mi = in.mean[(static_cast<size_t>(p) * 4 + i) * F + f];
        out.mean[(static_cast<size_t>(p) * 4 + i) * mk + at] =
            mi + g0 * ir + g1 * ib;
      }
#pragma unroll
      for (int c = 0; c < 10; ++c)
        out.cov[(static_cast<size_t>(p) * 10 + c) * mk + at] =
            in.cov[(static_cast<size_t>(p) * 10 + c) * F + f];
    }
  }
  if (lane == 0) out.sum[pm] = sum;
}

template <int kSlots>
__global__ void __launch_bounds__(kWarps * 32)
    select4_kernel(Channels4 in, const float* __restrict__ z, Outputs4 out,
                   int M, Loop a, int by_index) {
  constexpr int G = group<kSlots>();
  extern __shared__ float smem[];
  const int F = a.F;
  const int p = blockIdx.x;
  const size_t off = static_cast<size_t>(p) * F;
  const Staged s = stage(smem, F, off, in.r, in.b, in.lpw, in.si00, in.si01,
                         in.si11, in.lds);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int m0 = warp * G; m0 < M; m0 += kWarps * G) {
    const int n = min(G, M - m0);
    float sum[G], pv[G];
    bool hit[G];
    int pc[G];
    sweep<kSlots, G>(s, a, lane, z, m0, n, sum, hit, pv, pc);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= n) break;
      const int f = pc[g] < 0 ? 0 : s.slot[pc[g]];
      write_row4(in, z, out, p, F, M, m0 + g, off, lane, a.k1, pv[g], f,
                 sum[g], by_index);
    }
  }
}

// Rows wider than the register rows (F > 1024): sweep_wide, as in select.cu.
__global__ void __launch_bounds__(kWarps * 32)
    select4_wide_kernel(Channels4 in, const float* __restrict__ z,
                        Outputs4 out, int P, int M, Loop a, int by_index,
                        float* __restrict__ scratch) {
  const int F = a.F;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row =
      scratch + (static_cast<size_t>(blockIdx.x) * kWarps + warp) * F;
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const size_t off = static_cast<size_t>(p) * F;
    const Row rw{in.r + off,    in.b + off,    in.lpw + off, in.si00 + off,
                 in.si01 + off, in.si11 + off, in.lds + off};
    for (int m = warp; m < M; m += kWarps) {
      float sum, pv;
      bool hit;
      int pc;
      sweep_wide(rw, a, lane, z[2 * m], z[2 * m + 1], row, sum, hit, pv, pc);
      write_row4(in, z, out, p, F, M, m, off, lane, a.k1, pv,
                 pc < 0 ? 0 : pc, sum, by_index);
    }
  }
}

template <int kSlots>
cudaError_t launch(int P, size_t smem, cudaStream_t stream, Channels4 in,
                   const float* z, Outputs4 out, int M, Loop a,
                   int by_index) {
  select4_kernel<kSlots><<<P, kWarps * 32, smem, stream>>>(in, z, out, M, a,
                                                           by_index);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(int, size_t, cudaStream_t, Channels4,
                               const float*, Outputs4, int, Loop, int);
using Kernel = void (*)(Channels4, const float*, Outputs4, int, Loop, int);

}  // namespace

extern "C" {

// The seven loop channels are [P, F] row-major float32; gain, mean and cov
// are [P, 8, F], [P, 4, F] and [P, 10, F]; z is [M, 2]. Outputs: sum
// [P, M], w [P, M, k1], and either mean [P, 4, M, k1] and cov
// [P, 10, M, k1] (by_index = 0) or idx [P, M, k1] int32 (by_index = 1). The
// pointers a mode does not use may be null. scratch:
// phd_select_wide_floats(P, F) floats of device memory (null when that is
// 0). Returns the launch's cudaError_t.
int phd_select4_launch(const float* r, const float* b, const float* lpw,
                       const float* si00, const float* si01,
                       const float* si11, const float* lds, const float* gain,
                       const float* mean, const float* cov, const float* z,
                       float* sum_out, float* w_out, float* mean_out,
                       float* cov_out, int* idx_out, int P, int F, int M,
                       int k1, int by_index, float* scratch,
                       void* stream) {
  if (P <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  if (F <= 0 || k1 <= 0 || k1 > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch go =
      for_slots<Launch>(F, launch<1>, launch<2>, launch<4>, launch<8>,
                        launch<16>, launch<32>);
  if (go == nullptr && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Channels4 in{r, b, lpw, si00, si01, si11, lds, gain, mean, cov};
  Outputs4 out{sum_out, w_out, mean_out, cov_out, idx_out};
  const Loop a{F, k1, 0.0f, 0.0f, 0.0f, true, false};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (go != nullptr)
    return static_cast<int>(go(P, smem_bytes(F), st, in, z, out, M, a,
                               by_index));
  select4_wide_kernel<<<wide_ctas(P), kWarps * 32, 0, st>>>(
      in, z, out, P, M, a, by_index, scratch);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the kernel for F slots that fit on one SM, and its registers per
// thread in *regs (the wide-row kernel's above 1024 slots); 0 when F < 1.
int phd_select4_ctas_per_sm(int F, int* regs) {
  if (F <= 0) return 0;
  const Kernel k = for_slots<Kernel>(
      F, select4_kernel<1>, select4_kernel<2>, select4_kernel<4>,
      select4_kernel<8>, select4_kernel<16>, select4_kernel<32>);
  return k != nullptr ? ctas_per_sm(k, smem_bytes(F), regs)
                      : ctas_per_sm(select4_wide_kernel, 0, regs);
}

}  // extern "C"

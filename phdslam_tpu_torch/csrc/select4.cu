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
// fetches round j's payload from device memory, as before. F <= 1024; 40
// registers and 6 CTAs per SM at F = 512.

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

template <int kSlots>
__global__ void __launch_bounds__(kWarps * 32)
    select4_kernel(Channels4 in, const float* __restrict__ z, Outputs4 out,
                   int M, Loop a, int by_index) {
  constexpr int G = group<kSlots>();
  extern __shared__ float smem[];
  const int F = a.F, k1 = a.k1;
  const int p = blockIdx.x;
  const size_t off = static_cast<size_t>(p) * F;
  const Staged s = stage(smem, F, off, in.r, in.b, in.lpw, in.si00, in.si01,
                         in.si11, in.lds);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t mk = static_cast<size_t>(M) * k1;

  for (int m0 = warp * G; m0 < M; m0 += kWarps * G) {
    const int n = min(G, M - m0);
    float sum[G], pv[G];
    bool hit[G];
    int pc[G];
    sweep<kSlots, G>(s, a, lane, z, m0, n, sum, hit, pv, pc);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= n) break;
      const int m = m0 + g;
      const size_t pm = static_cast<size_t>(p) * M + m;
      if (lane < k1) {
        const float v = pv[g];
        const int f = pc[g] < 0 ? 0 : s.slot[pc[g]];
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
      if (lane == 0) out.sum[pm] = sum[g];
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
// pointers a mode does not use may be null. Returns the launch's
// cudaError_t.
int phd_select4_launch(const float* r, const float* b, const float* lpw,
                       const float* si00, const float* si01,
                       const float* si11, const float* lds, const float* gain,
                       const float* mean, const float* cov, const float* z,
                       float* sum_out, float* w_out, float* mean_out,
                       float* cov_out, int* idx_out, int P, int F, int M,
                       int k1, int by_index, void* stream) {
  if (P <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  const Launch go =
      for_slots<Launch>(F, launch<1>, launch<2>, launch<4>, launch<8>,
                        launch<16>, launch<32>);
  if (go == nullptr || k1 <= 0 || k1 > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  Channels4 in{r, b, lpw, si00, si01, si11, lds, gain, mean, cov};
  Outputs4 out{sum_out, w_out, mean_out, cov_out, idx_out};
  const Loop a{F, k1, 0.0f, 0.0f, 0.0f, true, false};
  return static_cast<int>(go(P, smem_bytes(F),
                             static_cast<cudaStream_t>(stream), in, z, out,
                             M, a, by_index));
}

// CTAs of the kernel for F slots that fit on one SM, and its registers per
// thread in *regs; 0 when F is out of range.
int phd_select4_ctas_per_sm(int F, int* regs) {
  const Kernel k = for_slots<Kernel>(
      F, select4_kernel<1>, select4_kernel<2>, select4_kernel<4>,
      select4_kernel<8>, select4_kernel<16>, select4_kernel<32>);
  return ctas_per_sm(k, F, regs);
}

}  // extern "C"

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
// seven loop channels in shared memory (14 KB at F = 512; with the eight
// row buffers 30 KB), one warp per measurement, shuffle argmax rounds; lane
// j fetches round j's payload from device memory.

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

__global__ void __launch_bounds__(kWarps * 32)
    select4_kernel(Channels4 in, const float* __restrict__ z, Outputs4 out,
                   int F, int M, int k1, int by_index) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  const size_t off = static_cast<size_t>(p) * F;
  const Staged s = stage(smem, F, off, in.r, in.b, in.lpw, in.si00, in.si01,
                         in.si11, in.lds);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row = s.rows + warp * F;
  const size_t mk = static_cast<size_t>(M) * k1;

  for (int m = warp; m < M; m += kWarps) {
    const size_t pm = static_cast<size_t>(p) * M + m;
    const float zr = z[2 * m];
    const float zb = z[2 * m + 1];
    bool hit;
    const float sum = likelihood_row(s, row, F, lane, zr, zb, false, 0.f,
                                     &hit);
    float my_v;
    int my_i;
    top_k1(row, F, k1, lane, &my_v, &my_i);

    if (lane < k1) {
      const bool alive = my_v > 0.0f;
      out.w[pm * k1 + lane] = alive ? my_v : 0.0f;
      if (by_index) {
        out.idx[pm * k1 + lane] = alive ? my_i : 0;
      } else {
        const float ir = zr - s.r[my_i];
        const float ib = wrap_round(zb - s.b[my_i]);
        const size_t at = static_cast<size_t>(m) * k1 + lane;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float g0 = in.gain[(static_cast<size_t>(p) * 8 + 2 * i) * F
                                   + my_i];
          const float g1 = in.gain[(static_cast<size_t>(p) * 8 + 2 * i + 1)
                                       * F + my_i];
          const float mi = in.mean[(static_cast<size_t>(p) * 4 + i) * F
                                   + my_i];
          out.mean[(static_cast<size_t>(p) * 4 + i) * mk + at] =
              mi + g0 * ir + g1 * ib;
        }
#pragma unroll
        for (int c = 0; c < 10; ++c)
          out.cov[(static_cast<size_t>(p) * 10 + c) * mk + at] =
              in.cov[(static_cast<size_t>(p) * 10 + c) * F + my_i];
      }
    }
    if (lane == 0) out.sum[pm] = sum;
  }
}

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
  if (F <= 0 || k1 <= 0 || k1 > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(F);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        select4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not see it
      return static_cast<int>(e);
    }
  }
  Channels4 in{r, b, lpw, si00, si01, si11, lds, gain, mean, cov};
  Outputs4 out{sum_out, w_out, mean_out, cov_out, idx_out};
  select4_kernel<<<P, kWarps * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(in, z, out, F, M, k1,
                                                        by_index);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

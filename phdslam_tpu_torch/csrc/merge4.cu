// Greedy moment-matching merge of a 4-D Gaussian-mixture candidate pool
// (the dynamic map of the mixed model), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel phdslam_tpu/kernels/merge_pallas.py ::
// greedy_merge4_pallas (Pallas body _kernel4, in both of its TPU layouts).
//
// What it computes, per particle, over K candidates (w, mean [4], cov [10]
// in the S4 order 00 01 02 03 11 12 13 22 23 33), until no weight is left or
// cap slots are filled:
//   1. pick the largest remaining weight, lowest index on ties;
//   2. select the remaining candidates j with dist_j < min_sep (and the
//      pick), dist_j = ||L^-1 d_j||^2 for d_j = mean_pick - mean_j and L the
//      Cholesky factor of (cov_pick + cov_j) / 2, factored channel by
//      channel with eps = 1e-12 under each sqrt (update4.chol4_solve_sq);
//   3. write their moment match, in one pass centred on the pick:
//      w = sum sw;  mu = pick - sum(sw d) / w;
//      cov = sum(sw (c + d d^T)) / w - mean(d) mean(d)^T;
//   4. zero the selected weights.
// Unused slots hold w = 0, mean 0 and the identity covariance.
//
// What bounds it on an H100: the serial chain of picks, as in merge.cu, but
// each candidate test is a 4x4 Cholesky and a triangular solve (4 sqrt,
// 10 divides, about 60 other flops) against merge.cu's dozen flops. The
// bytes (one read of the 15-channel pool, one write of the map) are small.
//
// Design: merge.cu's. One CTA of 256 threads per particle, the whole pool in
// shared memory (60 B per candidate: 42 KB at the shipped mixed pool
// K = 704, 65 KB at the dense K = 1088, so the launcher raises the dynamic
// shared-memory limit above 48 KB). Thread t owns candidates j = t
// (mod 256) and skips those already merged, so the remaining weights need
// no barrier between picks. Each pick ends in one block reduction
// (merge_common.cuh) of the 15 moment sums (1 + 4 + 10) and the next
// (max, argmax): a fixed shuffle tree per warp and a fixed-order sum across
// warps, double-buffered so that one __syncthreads per pick suffices. No
// atomics: every run gives the same result.

#include <cuda_runtime.h>

#include "merge_common.cuh"

namespace {

using phd_merge::better;
using phd_merge::block_reduce;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 15;
constexpr float kEps = 1e-12f;

struct Pool4 {
  const float *w, *mean, *cov;      // [P, K], [P, 4, K], [P, 10, K]
};

struct Merged4 {
  float *w, *mean, *cov;            // [P, cap], [P, 4, cap], [P, 10, cap]
};

// ||L^-1 d||^2 for the symmetric 4x4 a (S4 order): chol4_solve_sq.
__device__ __forceinline__ float chol4_solve_sq(const float (&a)[10],
                                                const float (&d)[4]) {
  const float l00 = sqrtf(fmaxf(a[0], kEps));
  const float l10 = a[1] / l00;
  const float l20 = a[2] / l00;
  const float l30 = a[3] / l00;
  const float l11 = sqrtf(fmaxf(a[4] - l10 * l10, kEps));
  const float l21 = (a[5] - l20 * l10) / l11;
  const float l31 = (a[6] - l30 * l10) / l11;
  const float l22 = sqrtf(fmaxf(a[7] - l20 * l20 - l21 * l21, kEps));
  const float l32 = (a[8] - l30 * l20 - l31 * l21) / l22;
  const float l33 =
      sqrtf(fmaxf(a[9] - l30 * l30 - l31 * l31 - l32 * l32, kEps));
  const float y0 = d[0] / l00;
  const float y1 = (d[1] - l10 * y0) / l11;
  const float y2 = (d[2] - l20 * y0 - l21 * y1) / l22;
  const float y3 = (d[3] - l30 * y0 - l31 * y1 - l32 * y2) / l33;
  return y0 * y0 + y1 * y1 + y2 * y2 + y3 * y3;
}

__global__ void __launch_bounds__(kThreads)
    merge4_kernel(Pool4 in, Merged4 out, int K, int cap, float min_sep) {
  extern __shared__ float smem[];
  float* s_w = smem;                // [K]
  float* s_m = s_w + K;             // [4, K]
  float* s_c = s_m + 4 * K;         // [10, K]
  __shared__ float red_f[2][kWarps * (kSums + 1)];
  __shared__ int red_i[2][kWarps];

  const int p = blockIdx.x;
  const size_t pk = static_cast<size_t>(p) * K;
  const int t = threadIdx.x;

  float mv = -1.0f;
  int mi = K;
  for (int j = t; j < K; j += kThreads) {
    const float w = in.w[pk + j];
    s_w[j] = w;
#pragma unroll
    for (int k = 0; k < 4; ++k) s_m[k * K + j] = in.mean[4 * pk + k * K + j];
#pragma unroll
    for (int c = 0; c < 10; ++c) s_c[c * K + j] = in.cov[10 * pk + c * K + j];
    better(mv, mi, w, j);
  }
  float s[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) s[k] = 0.f;
  // the barrier inside also publishes the staged pool
  block_reduce<kSums, kWarps>(s, mv, mi, red_f[1], red_i[1]);

  int i = 0;
  for (; i < cap && mv > 0.0f; ++i) {
    const int pick = mi;
    float rm[4], rc[10];
#pragma unroll
    for (int k = 0; k < 4; ++k) rm[k] = s_m[k * K + pick];
#pragma unroll
    for (int c = 0; c < 10; ++c) rc[c] = s_c[c * K + pick];
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] = 0.f;
    float nv = -1.0f;
    int ni = K;
    for (int j = t; j < K; j += kThreads) {
      const float w = s_w[j];
      if (!(w > 0.0f) && j != pick) continue;
      float c[10], a[10], d[4];
#pragma unroll
      for (int q = 0; q < 10; ++q) {
        c[q] = s_c[q * K + j];
        a[q] = 0.5f * (rc[q] + c[q]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = rm[k] - s_m[k * K + j];
      const float dist = chol4_solve_sq(a, d);
      if ((dist < min_sep && w > 0.0f) || j == pick) {
        s[0] += w;
#pragma unroll
        for (int k = 0; k < 4; ++k) s[1 + k] += w * d[k];
        int q = 0;
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = x; y < 4; ++y, ++q) s[5 + q] += w * (c[q] + d[x] * d[y]);
        s_w[j] = 0.0f;
      } else {
        better(nv, ni, w, j);
      }
    }
    block_reduce<kSums, kWarps>(s, nv, ni, red_f[i & 1], red_i[i & 1]);
    if (t == 0) {
      const float wsum = s[0];
      const bool live = wsum > 0.0f;
      const float inv = live ? 1.0f / fmaxf(wsum, 1e-38f) : 0.0f;
      float mc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) mc[k] = s[1 + k] * inv;
      const size_t oc = static_cast<size_t>(p) * cap + i;
      out.w[oc] = wsum;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        out.mean[4 * static_cast<size_t>(p) * cap + k * cap + i] =
            live ? rm[k] - mc[k] : 0.0f;
      int q = 0;
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = x; y < 4; ++y, ++q) {
          const float n = s[5 + q] * inv - mc[x] * mc[y];
          out.cov[10 * static_cast<size_t>(p) * cap + q * cap + i] =
              (x == y && !live) ? 1.0f : n;
        }
    }
    mv = nv;
    mi = ni;
  }
  for (int k = i + t; k < cap; k += kThreads) {
    out.w[static_cast<size_t>(p) * cap + k] = 0.0f;
#pragma unroll
    for (int x = 0; x < 4; ++x)
      out.mean[4 * static_cast<size_t>(p) * cap + x * cap + k] = 0.0f;
#pragma unroll
    for (int q = 0; q < 10; ++q)
      out.cov[10 * static_cast<size_t>(p) * cap + q * cap + k] =
          (q == 0 || q == 4 || q == 7 || q == 9) ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" {

// Pool: w [P, K], mean [P, 4, K], cov [P, 10, K], row-major float32.
// Outputs: w [P, cap], mean [P, 4, cap], cov [P, 10, cap]. Returns the
// launch's cudaError_t (including the refusal of a pool too large for one
// CTA's shared memory).
int phd_merge4_launch(const float* w, const float* mean, const float* cov,
                      float* ow, float* omean, float* ocov, int P, int K,
                      int cap, float min_sep, void* stream) {
  if (P <= 0 || cap <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kSums) * K * sizeof(float);
  const cudaError_t e = phd_merge::allow_smem(merge4_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Pool4 in{w, mean, cov};
  Merged4 out{ow, omean, ocov};
  merge4_kernel<<<P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, out, K, cap, min_sep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

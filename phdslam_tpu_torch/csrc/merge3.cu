// Greedy moment-matching merge of a 3-D Gaussian-mixture candidate pool
// (disparity-space features of the monocular SC-PHD pipeline), hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel phdslam_tpu/kernels/merge_pallas.py ::
// greedy_merge3_pallas (Pallas body _kernel3, in both of its TPU layouts).
//
// What it computes, per particle, over K candidates (w, mean m0 m1 m2, cov
// c00 c01 c02 c11 c12 c22), until no weight is left or cap slots are filled:
//   1. pick the largest remaining weight, lowest index on ties;
//   2. select the remaining candidates j with dist_j < min_sep (and the
//      pick), dist_j = d^T adj(A) d / det(A) for d = mean_pick - mean_j and
//      A = (cov_pick + cov_j) / 2, with the closed-form 3x3 adjugate and
//      determinant and an IEEE division by det with no guard (det <= 0 gives
//      inf or NaN, which never passes the test);
//   3. write their moment match, in one pass centred on the pick:
//      w = sum sw;  mu = pick - sum(sw d) / w;
//      cov = sum(sw (c + d d^T)) / w - mean(d) mean(d)^T;
//   4. zero the selected weights.
// Unused slots hold w = 0, mean 0 and the identity covariance.
//
// What bounds it on an H100: the serial chain of picks, as in merge.cu; a
// candidate test is about 60 flops and one divide. The bytes (one read of
// the 10-channel pool, one write of the map) are small.
//
// Design: merge.cu's. One CTA of 128 threads per particle, the whole pool in
// shared memory (40 B per candidate: 19.8 KB at the shipped disparity pool
// K = 496, 22.4 KB at K = 560). Thread t owns candidates j = t (mod 128) and
// skips those already merged, so the remaining weights need no barrier
// between picks. Each pick ends in one block reduction (merge_common.cuh)
// of the 10 moment sums (1 + 3 + 6) and the next (max, argmax).

#include <cuda_runtime.h>

#include "merge_common.cuh"

namespace {

using phd_merge::better;
using phd_merge::block_reduce;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChannels = 10;       // w, m0 m1 m2, c00 c01 c02 c11 c12 c22
constexpr int kSums = 10;           // w, sw d (3), sw (c + d d^T) (6)

struct Pool3 {
  const float* ch[kChannels];       // each [P, K]
};

struct Merged3 {
  float* ch[kChannels];             // each [P, cap]
};

// The covariance channel of pair (x, y), x <= y, in the order above.
__host__ __device__ constexpr int cov_index(int x, int y) {
  return x == 0 ? y : (x == 1 ? 2 + y : 5);
}

__global__ void __launch_bounds__(kThreads)
    merge3_kernel(Pool3 in, Merged3 out, int K, int cap, float min_sep) {
  extern __shared__ float smem[];
  float* s_w = smem;                // [K]
  float* s_m = s_w + K;             // [3, K]
  float* s_c = s_m + 3 * K;         // [6, K]
  __shared__ float red_f[2][kWarps * (kSums + 1)];
  __shared__ int red_i[2][kWarps];

  const int p = blockIdx.x;
  const size_t pk = static_cast<size_t>(p) * K;
  const size_t pc = static_cast<size_t>(p) * cap;
  const int t = threadIdx.x;

  float mv = -1.0f;
  int mi = K;
  for (int j = t; j < K; j += kThreads) {
    const float w = in.ch[0][pk + j];
    s_w[j] = w;
#pragma unroll
    for (int c = 1; c < kChannels; ++c) smem[c * K + j] = in.ch[c][pk + j];
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
    float rm[3], rc[6];
#pragma unroll
    for (int k = 0; k < 3; ++k) rm[k] = s_m[k * K + pick];
#pragma unroll
    for (int q = 0; q < 6; ++q) rc[q] = s_c[q * K + pick];
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] = 0.f;
    float nv = -1.0f;
    int ni = K;
    for (int j = t; j < K; j += kThreads) {
      const float w = s_w[j];
      if (!(w > 0.0f) && j != pick) continue;
      float c[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) c[q] = s_c[q * K + j];
      const float a00 = 0.5f * (rc[0] + c[0]);
      const float a01 = 0.5f * (rc[1] + c[1]);
      const float a02 = 0.5f * (rc[2] + c[2]);
      const float a11 = 0.5f * (rc[3] + c[3]);
      const float a12 = 0.5f * (rc[4] + c[4]);
      const float a22 = 0.5f * (rc[5] + c[5]);
      const float det = a00 * (a11 * a22 - a12 * a12) -
                        a01 * (a01 * a22 - a12 * a02) +
                        a02 * (a01 * a12 - a11 * a02);
      const float i00 = a11 * a22 - a12 * a12;
      const float i01 = a02 * a12 - a01 * a22;
      const float i02 = a01 * a12 - a02 * a11;
      const float i11 = a00 * a22 - a02 * a02;
      const float i12 = a02 * a01 - a00 * a12;
      const float i22 = a00 * a11 - a01 * a01;
      float d[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) d[k] = rm[k] - s_m[k * K + j];
      const float dist =
          (d[0] * d[0] * i00 + d[1] * d[1] * i11 + d[2] * d[2] * i22 +
           2.0f * (d[0] * d[1] * i01 + d[0] * d[2] * i02 +
                   d[1] * d[2] * i12)) /
          det;
      if ((dist < min_sep && w > 0.0f) || j == pick) {
        s[0] += w;
#pragma unroll
        for (int k = 0; k < 3; ++k) s[1 + k] += w * d[k];
#pragma unroll
        for (int x = 0; x < 3; ++x)
#pragma unroll
          for (int y = x; y < 3; ++y) {
            const int q = cov_index(x, y);
            s[4 + q] += w * (c[q] + d[x] * d[y]);
          }
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
      float mc[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) mc[k] = s[1 + k] * inv;
      out.ch[0][pc + i] = wsum;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        out.ch[1 + k][pc + i] = live ? rm[k] - mc[k] : 0.0f;
#pragma unroll
      for (int x = 0; x < 3; ++x)
#pragma unroll
        for (int y = x; y < 3; ++y) {
          const int q = cov_index(x, y);
          const float n = s[4 + q] * inv - mc[x] * mc[y];
          out.ch[4 + q][pc + i] = (x == y && !live) ? 1.0f : n;
        }
    }
    mv = nv;
    mi = ni;
  }
  for (int k = i + t; k < cap; k += kThreads) {
#pragma unroll
    for (int c = 0; c < kChannels; ++c)
      out.ch[c][pc + k] = (c == 4 || c == 7 || c == 9) ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" {

// Pool: ten [P, K] row-major float32 channels (w, m0, m1, m2, c00, c01, c02,
// c11, c12, c22); outputs: the same ten channels, [P, cap]. Returns the
// launch's cudaError_t (including the refusal of a pool too large for one
// CTA's shared memory).
int phd_merge3_launch(const float* w, const float* m0, const float* m1,
                      const float* m2, const float* c00, const float* c01,
                      const float* c02, const float* c11, const float* c12,
                      const float* c22, float* ow, float* om0, float* om1,
                      float* om2, float* o00, float* o01, float* o02,
                      float* o11, float* o12, float* o22, int P, int K,
                      int cap, float min_sep, void* stream) {
  if (P <= 0 || cap <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kChannels) * K * sizeof(float);
  const cudaError_t e = phd_merge::allow_smem(merge3_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Pool3 in{{w, m0, m1, m2, c00, c01, c02, c11, c12, c22}};
  Merged3 out{{ow, om0, om1, om2, o00, o01, o02, o11, o12, o22}};
  merge3_kernel<<<P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, out, K, cap, min_sep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

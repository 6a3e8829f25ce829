// Greedy moment-matching merge of a Gaussian-mixture candidate pool,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel phdslam_tpu/kernels/merge_pallas.py ::
// greedy_merge_pallas (Pallas body _kernel_kt; _kernel is the same
// function in the other TPU layout, so this one kernel covers both), for
// distance metric 0 (Mahalanobis with the averaged covariance, as the
// division-free test quad < min_sep * det) and metric 1 (Hellinger).
//
// What it computes, per particle, over K candidates (w, mx, my, c00, c01,
// c11), until no weight is left or max_out slots are filled:
//   1. pick the largest remaining weight, lowest index on ties;
//   2. select the remaining candidates near the pick (and the pick);
//   3. write their moment match, computed in one pass centred on the pick:
//      w = sum sw;  mu = pick - sum(sw d) / w;
//      cov = sum(sw (c + d d^T)) / w - mean(d) mean(d)^T;
//   4. zero the selected weights.
// Unused slots hold w = 0, mean 0 and the identity covariance.
//
// What bounds it on an H100: the serial chain of picks. Each pick is a pass
// over the particle's K candidates and one block reduction that the next
// pick depends on; the bytes (one read of the pool, one write of the map)
// are small. At the dense pool (8192 x 1088 -> 512) a particle makes a few
// hundred picks.
//
// Design: one CTA of 128 threads per particle, the particle's whole pool in
// shared memory (24 B per candidate, 26 KB at K = 1088). Thread t owns
// candidates j = t (mod 128), so the remaining weights need no barrier
// between picks; candidates already merged are skipped. Each pick ends in
// one block reduction (merge_common.cuh) of the six moment sums and the
// next (max, argmax), as a fixed shuffle tree per warp and a fixed-order
// sum across warps (double-buffered, so one __syncthreads per pick): no
// atomics, and the same result on every run. Every thread combines the
// warp partials itself, so the whole block holds the next pick without a
// second barrier.

#include <cuda_runtime.h>

#include "merge_common.cuh"

namespace {

using phd_merge::better;
using phd_merge::block_reduce;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 6;

struct Pool {
  const float *w, *mx, *my, *c00, *c01, *c11;
};

struct Merged {
  float *w, *mx, *my, *c00, *c01, *c11;
};

__global__ void __launch_bounds__(kThreads)
    merge_kernel(Pool in, Merged out, int K, int cap, float min_sep,
                 int metric) {
  extern __shared__ float smem[];
  float* s_w = smem;
  float* s_mx = s_w + K;
  float* s_my = s_mx + K;
  float* s_c00 = s_my + K;
  float* s_c01 = s_c00 + K;
  float* s_c11 = s_c01 + K;
  __shared__ float red_f[2][kWarps * (kSums + 1)];
  __shared__ int red_i[2][kWarps];

  const int p = blockIdx.x;
  const size_t off = static_cast<size_t>(p) * K;
  const size_t o_off = static_cast<size_t>(p) * cap;
  const int t = threadIdx.x;

  float mv = -1.0f;
  int mi = K;
  for (int j = t; j < K; j += kThreads) {
    const float w = in.w[off + j];
    s_w[j] = w;
    s_mx[j] = in.mx[off + j];
    s_my[j] = in.my[off + j];
    s_c00[j] = in.c00[off + j];
    s_c01[j] = in.c01[off + j];
    s_c11[j] = in.c11[off + j];
    better(mv, mi, w, j);
  }
  float s[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // the barrier inside also publishes the staged pool
  block_reduce<kSums, kWarps>(s, mv, mi, red_f[1], red_i[1]);

  int i = 0;
  for (; i < cap && mv > 0.0f; ++i) {
    const int pick = mi;
    const float rmx = s_mx[pick], rmy = s_my[pick];
    const float r00 = s_c00[pick], r01 = s_c01[pick], r11 = s_c11[pick];
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] = 0.f;
    float nv = -1.0f;
    int ni = K;
    for (int j = t; j < K; j += kThreads) {
      const float w = s_w[j];
      if (!(w > 0.0f) && j != pick) continue;
      const float c00 = s_c00[j], c01 = s_c01[j], c11 = s_c11[j];
      const float dx = rmx - s_mx[j];
      const float dy = rmy - s_my[j];
      const float dx2 = dx * dx, dxy = dx * dy, dy2 = dy * dy;
      bool near;
      if (metric == 1) {
        const float s00 = r00 + c00, s01 = r01 + c01, s11 = r11 + c11;
        const float det_sum = s00 * s11 - s01 * s01;
        const float safe = fmaxf(det_sum, 1.17549435e-38f);
        const float eps_q =
            -0.25f * (dx * dx * s11 - 2.0f * dx * dy * s01 + dy * dy * s00) /
            safe;
        const float det_prod =
            (r00 * c00 + r01 * c01) * (r01 * c01 + r11 * c11) -
            (r00 * c01 + r01 * c11) * (r01 * c00 + r11 * c01);
        const float dist =
            1.0f - sqrtf(fmaxf(sqrtf(fmaxf(det_prod, 0.0f)) /
                                   (det_sum / 4.0f),
                               0.0f)) *
                       expf(eps_q);
        near = dist < min_sep;
      } else {
        const float a00 = 0.5f * (r00 + c00);
        const float a01 = 0.5f * (r01 + c01);
        const float a11 = 0.5f * (r11 + c11);
        const float det = a00 * a11 - a01 * a01;
        const float quad = dx2 * a11 - 2.0f * dxy * a01 + dy2 * a00;
        near = quad < min_sep * det;
      }
      if ((near && w > 0.0f) || j == pick) {
        s[0] += w;
        s[1] += w * dx;
        s[2] += w * dy;
        s[3] += w * (c00 + dx2);
        s[4] += w * (c01 + dxy);
        s[5] += w * (c11 + dy2);
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
      const float mcx = s[1] * inv, mcy = s[2] * inv;
      const float n00 = s[3] * inv - mcx * mcx;
      const float n01 = s[4] * inv - mcx * mcy;
      const float n11 = s[5] * inv - mcy * mcy;
      out.w[o_off + i] = wsum;
      out.mx[o_off + i] = live ? rmx - mcx : 0.0f;
      out.my[o_off + i] = live ? rmy - mcy : 0.0f;
      out.c00[o_off + i] = live ? n00 : 1.0f;
      out.c01[o_off + i] = n01;
      out.c11[o_off + i] = live ? n11 : 1.0f;
    }
    mv = nv;
    mi = ni;
  }
  for (int k = i + t; k < cap; k += kThreads) {
    out.w[o_off + k] = 0.0f;
    out.mx[o_off + k] = 0.0f;
    out.my[o_off + k] = 0.0f;
    out.c00[o_off + k] = 1.0f;
    out.c01[o_off + k] = 0.0f;
    out.c11[o_off + k] = 1.0f;
  }
}

}  // namespace

extern "C" {

// Pool channels are [P, K] row-major float32, outputs [P, cap]. Returns the
// launch's cudaError_t.
int phd_merge_launch(const float* w, const float* mx, const float* my,
                     const float* c00, const float* c01, const float* c11,
                     float* ow, float* omx, float* omy, float* o00,
                     float* o01, float* o11, int P, int K, int cap,
                     float min_sep, int metric, void* stream) {
  if (P <= 0 || cap <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(6) * K * sizeof(float);
  const cudaError_t e = phd_merge::allow_smem(merge_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Pool in{w, mx, my, c00, c01, c11};
  Merged out{ow, omx, omy, o00, o01, o11};
  merge_kernel<<<P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, out, K, cap, min_sep, metric);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

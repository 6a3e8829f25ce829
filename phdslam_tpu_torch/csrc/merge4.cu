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
// What bounds it on an H100: the serial chain of picks. The bytes (one
// read of the 15-channel pool, one write of the map) are small; what costs
// is the latency of each pick's dependent steps (find the pick, test the
// candidates after it, publish what it took) and the IEEE square roots and
// divisions of the candidate tests. The design cuts both.
//
// Design (merge_common.cuh, "the presorted design"): one CTA of kThreads
// threads per particle. The live candidates are sorted once by (w desc,
// index asc), which is the greedy pick order, and staged in shared memory
// in that order, so a pick never scans a dead slot or the merged prefix.
// Picks go in batches of kBatch: one pass tests each unmerged candidate
// after the first pick against the batch picks before it (kBatch
// independent chains per thread), the first near pick takes it (owner =
// slot, nothing else), and the batch ends in one __syncthreads; a batch pick
// near an earlier one cuts the batch there. After the loop one warp threads
// each slot's members into a list in sorted order and one thread per slot
// sums the slot's moments along it (fixed order, no atomics on floats: the
// same result on every run).
//
// The neighbour test exits early, exactly, in two steps:
//   - maybe(): the first pivot alone, without a square root or a division.
//     d0^2 > k0 max(a0, eps) in double (d0^2 exact, the margin 2^-21 of
//     k0 = mid^2 (1 + 2^-21) well above the product's rounding and that of
//     the float sqrt), with mid the midpoint below v*, the least float with
//     fl(v* v*) >= min_sep, means |d0| / fl(sqrt(max(a0, eps))) > mid, so
//     y0 rounds to |y0| >= v* and fl(y0 y0) >= min_sep.
//   - confirm(): the first two pivots (clamped as always), y0 and y1;
//     reject when partial = y0^2 + y1^2 >= min_sep, else finish the factor.
// The full distance is formed from that same partial, (partial + y2^2) +
// y3^2, and partial is y0^2 + y1^2: adding a non-negative term never lowers
// a float sum in round-to-nearest (with or without FMA), so dist >= partial
// >= fl(y0 y0), and both exits take the full test's decision. A NaN falls
// through to the full test, which rejects it as before.
//
// Shared memory: (4 * 15 + 6) = 66 B per candidate plus 112 B, 70 KB at the
// dense K = 1088, so 3 CTAs fit on an SM; the widest pool in shared memory
// is K = 3520 (227 KB). A wider one runs merge4_wide_kernel, the same code
// on a pool in device memory (72 B per candidate and CTA, 1024 CTAs at
// most): K is bounded by device memory alone.

#include <cuda_runtime.h>

#include <atomic>

#include "merge_common.cuh"

namespace {

using phd_merge::Books;

constexpr int kThreads = 256;       // 128: 1.2x slower on an H100
constexpr int kBatch = 8;           // picks per pass
constexpr int kChannels = 15;       // w, mean [4], cov [10]
constexpr float kEps = 1e-12f;

struct Pool4 {
  const float *w, *mean, *cov;      // [P, K], [P, 4, K], [P, 10, K]
};

struct Merged4 {
  float *w, *mean, *cov;            // [P, cap], [P, 4, cap], [P, 10, cap]
};

// The factor on which the division-free first test rejects: mid^2 (1 +
// 2^-21), mid the midpoint below v*, the least float with fl(v* v*) >=
// min_sep; +inf (no early decision) unless 0 < min_sep < 3e38.
__device__ double reject_scale(float min_sep) {
  if (!(min_sep > 0.0f && min_sep < 3.0e38f))
    return __longlong_as_double(0x7ff0000000000000ll);
  float v = sqrtf(min_sep);
  while (__fmul_rn(v, v) >= min_sep) v = nextafterf(v, 0.0f);
  while (__fmul_rn(v, v) < min_sep) v = nextafterf(v, 3.4e38f);
  const double mid = 0.5 * (static_cast<double>(nextafterf(v, 0.0f)) +
                            static_cast<double>(v));
  return mid * mid * (1.0 + 0x1p-21);
}

// The neighbour test against the batch's picks, on the sorted pool.
struct Near4 {
  const float* m;                   // [4][K]
  const float* c;                   // [10][K]
  int K;
  float min_sep;
  double k0;                        // reject_scale(min_sep)
  float rm0[kBatch], rc0[kBatch];   // the picks' mean0 and cov00

  struct Cand {
    float m0, c0;
  };

  __device__ void pick(int j, int pos) {
    rm0[j] = m[pos];
    rc0[j] = c[pos];
  }

  __device__ Cand load(int p) const { return {m[p], c[p]}; }

  // The first pivot alone, without a division: d0^2 > k0 max(a0, eps)
  // (in double, within the margin of k0) means |d0| / l00 > mid, so
  // y0 = fl(d0 / l00) has
  // |y0| >= v*, fl(y0 y0) >= min_sep and dist >= partial >= fl(y0 y0)
  // (each sum adds a non-negative term): the test is false.
  __device__ bool maybe(int j, const Cand& x) const {
    const float a0 = 0.5f * (rc0[j] + x.c0);
    const float d0 = rm0[j] - x.m0;
    const double dd = static_cast<double>(d0) * static_cast<double>(d0);
    return !(dd > k0 * static_cast<double>(fmaxf(a0, kEps)));
  }

  // dist < min_sep for dist = ||L^-1 d||^2 (chol4_solve_sq) of position p
  // against the pick at pos, with the exact early reject on partial
  __device__ bool confirm(int pos, int p) const {
    float rm[4], rc[10];
#pragma unroll
    for (int k = 0; k < 4; ++k) rm[k] = m[k * K + pos];
#pragma unroll
    for (int q = 0; q < 10; ++q) rc[q] = c[q * K + pos];
    const float a0 = 0.5f * (rc[0] + c[p]);
    const float a1 = 0.5f * (rc[1] + c[K + p]);
    const float a4 = 0.5f * (rc[4] + c[4 * K + p]);
    const float d0 = rm[0] - m[p];
    const float d1 = rm[1] - m[K + p];
    const float l00 = sqrtf(fmaxf(a0, kEps));
    const float l10 = a1 / l00;
    const float l11 = sqrtf(fmaxf(a4 - l10 * l10, kEps));
    const float y0 = d0 / l00;
    const float y1 = (d1 - l10 * y0) / l11;
    const float partial = y0 * y0 + y1 * y1;
    if (partial >= min_sep) return false;
    const float a2 = 0.5f * (rc[2] + c[2 * K + p]);
    const float a3 = 0.5f * (rc[3] + c[3 * K + p]);
    const float a5 = 0.5f * (rc[5] + c[5 * K + p]);
    const float a6 = 0.5f * (rc[6] + c[6 * K + p]);
    const float a7 = 0.5f * (rc[7] + c[7 * K + p]);
    const float a8 = 0.5f * (rc[8] + c[8 * K + p]);
    const float a9 = 0.5f * (rc[9] + c[9 * K + p]);
    const float d2 = rm[2] - m[2 * K + p];
    const float d3 = rm[3] - m[3 * K + p];
    const float l20 = a2 / l00;
    const float l30 = a3 / l00;
    const float l21 = (a5 - l20 * l10) / l11;
    const float l31 = (a6 - l30 * l10) / l11;
    const float l22 = sqrtf(fmaxf(a7 - l20 * l20 - l21 * l21, kEps));
    const float l32 = (a8 - l30 * l20 - l31 * l21) / l22;
    const float l33 =
        sqrtf(fmaxf(a9 - l30 * l30 - l31 * l31 - l32 * l32, kEps));
    const float y2 = (d2 - l20 * y0 - l21 * y1) / l22;
    const float y3 = (d3 - l30 * y0 - l31 * y1 - l32 * y2) / l33;
    const float dist = (partial + y2 * y2) + y3 * y3;
    return dist < min_sep;
  }
};

// One slot's moment match, centred on its pick:
//   w = sum sw;  mu = pick - sum(sw d) / w;
//   cov = sum(sw (c + d d^T)) / w - mean(d) mean(d)^T.
struct Moments4 {
  const float *w, *m, *c;           // the sorted pool
  int K, cap;
  Merged4 out;
  size_t o;                         // p * cap
  float rm[4], s[kChannels];        // the slot's pick mean and sums

  __device__ void begin(int pp) {
#pragma unroll
    for (int k = 0; k < 4; ++k) rm[k] = m[k * K + pp];
#pragma unroll
    for (int k = 0; k < kChannels; ++k) s[k] = 0.f;
    add(pp);
  }

  __device__ void add(int j) {
    const float wj = w[j];
    float d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = rm[k] - m[k * K + j];
    s[0] += wj;
#pragma unroll
    for (int k = 0; k < 4; ++k) s[1 + k] += wj * d[k];
    int q = 0;
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = x; y < 4; ++y, ++q)
        s[5 + q] += wj * (c[q * K + j] + d[x] * d[y]);
  }

  __device__ void store(int i) const {
    const float wsum = s[0];
    const bool live = wsum > 0.0f;
    const float inv = live ? 1.0f / fmaxf(wsum, 1e-38f) : 0.0f;
    float mc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) mc[k] = s[1 + k] * inv;
    out.w[o + i] = wsum;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out.mean[4 * o + k * cap + i] = live ? rm[k] - mc[k] : 0.0f;
    int q = 0;
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = x; y < 4; ++y, ++q) {
        const float v = s[5 + q] * inv - mc[x] * mc[y];
        out.cov[10 * o + q * cap + i] = (x == y && !live) ? 1.0f : v;
      }
  }

  __device__ void empty(int i) const {
    out.w[o + i] = 0.0f;
#pragma unroll
    for (int x = 0; x < 4; ++x) out.mean[4 * o + x * cap + i] = 0.0f;
#pragma unroll
    for (int q = 0; q < 10; ++q)
      out.cov[10 * o + q * cap + i] =
          (q == 0 || q == 4 || q == 7 || q == 9) ? 1.0f : 0.0f;
  }
};

// The merge of particle p's pool, in pool (shared or device memory, Idx
// as merge_common.cuh says).
template <typename Idx>
__device__ __forceinline__ void merge4_particle(const Pool4& in,
                                                const Merged4& out, int p,
                                                int K, int cap, float min_sep,
                                                float* pool) {
  const Books<Idx> b(pool, kChannels, K);
  float* s_w = pool;
  float* s_m = s_w + K;
  float* s_c = s_m + 4 * K;
  const size_t pk = static_cast<size_t>(p) * K;

  const int L = phd_merge::presort<kThreads>(in.w + pk, K, pool, b);
  {
    const float* src[kChannels];
    src[0] = in.w + pk;
#pragma unroll
    for (int k = 0; k < 4; ++k) src[1 + k] = in.mean + 4 * pk + k * K;
#pragma unroll
    for (int q = 0; q < 10; ++q) src[5 + q] = in.cov + 10 * pk + q * K;
    phd_merge::stage<kThreads, kChannels>(src, K, pool, b);
  }

  Near4 test{s_m, s_c, K, min_sep, reject_scale(min_sep)};
  const int n = phd_merge::pick_loop<kThreads, kBatch>(test, L, cap, b);
  Moments4 acc{s_w, s_m, s_c, K, cap, out, static_cast<size_t>(p) * cap};
  phd_merge::moments<kThreads>(acc, L, n, cap, b);
}

__global__ void __launch_bounds__(kThreads, 3)
    merge4_kernel(Pool4 in, Merged4 out, int K, int cap, float min_sep) {
  extern __shared__ float pool[];   // [15][K]: w, mean [4], cov [10]
  merge4_particle<unsigned short>(in, out, blockIdx.x, K, cap, min_sep,
                                  pool);
}

// A pool too wide for a CTA's shared memory: one pool per CTA in scratch
// (device memory), the CTAs striding over the particles.
__global__ void __launch_bounds__(kThreads)
    merge4_wide_kernel(Pool4 in, Merged4 out, int P, int K, int cap,
                       float min_sep, float* scratch) {
  float* pool = scratch + blockIdx.x *
                              phd_merge::wide_pool_floats(kChannels, K);
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    merge4_particle<unsigned>(in, out, p, K, cap, min_sep, pool);
    __syncthreads();                // the pool is the next particle's
  }
}

__global__ void reject_scale_kernel(const float* min_sep, double* k0,
                                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) k0[i] = reject_scale(min_sep[i]);
}

std::atomic<unsigned> g_carved{0};  // devices where the carveout is set

}  // namespace

extern "C" {

// Floats of device-memory scratch a launch of P pools of K candidates
// takes: 0 while a pool fits a CTA's shared memory (K <= 3520 on an H100).
long long phd_merge4_wide_floats(int P, int K) {
  if (P <= 0 || K <= 0 ||
      phd_merge::fits_shared(merge4_kernel,
                             phd_merge::smem_bytes(kChannels, K)))
    return 0;
  return phd_merge::wide_floats(kChannels, P, K);
}

// Pool: w [P, K], mean [P, 4, K], cov [P, 10, K], row-major float32.
// Outputs: w [P, cap], mean [P, 4, cap], cov [P, 10, cap]; scratch:
// phd_merge4_wide_floats(P, K) floats of device memory (null when that is
// 0). Returns the launch's cudaError_t.
int phd_merge4_launch(const float* w, const float* mean, const float* cov,
                      float* ow, float* omean, float* ocov, int P, int K,
                      int cap, float min_sep, float* scratch, void* stream) {
  if (P <= 0 || cap <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Pool4 in{w, mean, cov};
  Merged4 out{ow, omean, ocov};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = phd_merge::smem_bytes(kChannels, K);
  if (!phd_merge::fits_shared(merge4_kernel, smem)) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    merge4_wide_kernel<<<phd_merge::wide_ctas(P), kThreads, 0, st>>>(
        in, out, P, K, cap, min_sep, scratch);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t e =
      phd_merge::allow_smem_max(merge4_kernel, smem, g_carved);
  if (e != cudaSuccess) return static_cast<int>(e);
  merge4_kernel<<<P, kThreads, smem, st>>>(in, out, K, cap, min_sep);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the kernel that fit on one SM for a pool of K candidates.
int phd_merge4_ctas_per_sm(int K) {
  return phd_merge::ctas_per_sm(merge4_kernel, kThreads,
                                phd_merge::smem_bytes(kChannels, K), g_carved);
}

// k0[i] = reject_scale(min_sep[i]) as the kernel computes it on the card
// (n floats in, n doubles out, device memory), for a test against the
// Python copy kernels/merge4.py::reject_scale.
int phd_merge4_reject_scale(const float* min_sep, double* k0, int n,
                            void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  reject_scale_kernel<<<(n + 127) / 128, 128, 0,
                        static_cast<cudaStream_t>(stream)>>>(min_sep, k0, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

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
// What bounds it on an H100: the serial chain of picks. The bytes (one
// read of the pool, one write of the map) are small; at the dense pool
// (8192 x 1088 -> 512) a particle makes a few hundred picks, each a dozen
// flops per candidate tested, and what costs is the latency of each pick's
// dependent steps (find the pick, test the candidates after it, publish
// what it took).
//
// Design (merge_common.cuh, "the presorted design"): one CTA of kThreads
// threads per particle. The live candidates are sorted once by (w desc,
// index asc), the greedy pick order, and staged in shared memory in that
// order, so a pick never scans a dead slot or the merged prefix. Picks go
// in batches of kBatch: one pass tests each unmerged candidate after the
// first pick against the batch picks before it (kBatch independent chains
// per thread), the first near pick takes it (owner = slot, nothing else),
// and the batch ends in one __syncthreads; a batch pick near an earlier one
// cuts the batch there. After the loop one warp threads each slot's members
// into a list in sorted order and one thread per slot sums the slot's
// moments along it: a fixed order, no atomics on floats, the same result
// on every run. The metric is a template parameter, so no test branches on
// it.
//
// Shared memory: (4 * 6 + 6) = 30 B per candidate plus 112 B, 32 KB at the
// dense K = 1088 (6 CTAs on an SM); the widest pool in shared memory is
// K = 7744 (227 KB). A wider one runs merge_wide_kernel, the same code on
// a pool in device memory (36 B per candidate and CTA, 1024 CTAs at most):
// K is bounded by device memory alone.

#include <cuda_runtime.h>

#include <atomic>

#include "merge_common.cuh"

namespace {

using phd_merge::Books;

constexpr int kThreads = 128;       // 256: 1.4x slower on an H100
constexpr int kBatch = 8;           // picks per pass
constexpr int kChannels = 6;        // w, mx, my, c00, c01, c11

struct Pool {
  const float *w, *mx, *my, *c00, *c01, *c11;
};

struct Merged {
  float *w, *mx, *my, *c00, *c01, *c11;
};

// The neighbour test against the batch's picks, on the sorted pool, for
// metric kMetric; the test is cheap and exact, so maybe() is the whole of
// it.
template <int kMetric>
struct Near {
  const float *mx, *my, *c00, *c01, *c11;
  float min_sep;
  float rmx[kBatch], rmy[kBatch], r00[kBatch], r01[kBatch], r11[kBatch];

  struct Cand {
    float mx, my, c00, c01, c11;
  };

  __device__ void pick(int j, int pos) {
    rmx[j] = mx[pos];
    rmy[j] = my[pos];
    r00[j] = c00[pos];
    r01[j] = c01[pos];
    r11[j] = c11[pos];
  }

  __device__ Cand load(int p) const {
    return {mx[p], my[p], c00[p], c01[p], c11[p]};
  }

  __device__ bool maybe(int j, const Cand& x) const {
    const float dx = rmx[j] - x.mx;
    const float dy = rmy[j] - x.my;
    if (kMetric == 1) {
      const float s00 = r00[j] + x.c00, s01 = r01[j] + x.c01,
                  s11 = r11[j] + x.c11;
      const float det_sum = s00 * s11 - s01 * s01;
      const float safe = fmaxf(det_sum, 1.17549435e-38f);
      const float eps_q =
          -0.25f * (dx * dx * s11 - 2.0f * dx * dy * s01 + dy * dy * s00) /
          safe;
      const float det_prod =
          (r00[j] * x.c00 + r01[j] * x.c01) *
              (r01[j] * x.c01 + r11[j] * x.c11) -
          (r00[j] * x.c01 + r01[j] * x.c11) *
              (r01[j] * x.c00 + r11[j] * x.c01);
      const float dist =
          1.0f -
          sqrtf(fmaxf(sqrtf(fmaxf(det_prod, 0.0f)) / (det_sum / 4.0f),
                      0.0f)) *
              expf(eps_q);
      return dist < min_sep;
    }
    const float a00 = 0.5f * (r00[j] + x.c00);
    const float a01 = 0.5f * (r01[j] + x.c01);
    const float a11 = 0.5f * (r11[j] + x.c11);
    const float det = a00 * a11 - a01 * a01;
    const float quad = dx * dx * a11 - 2.0f * (dx * dy) * a01 + dy * dy * a00;
    return quad < min_sep * det;
  }

  __device__ bool confirm(int, int) const { return true; }
};

// One slot's moment match, centred on its pick:
//   w = sum sw;  mu = pick - sum(sw d) / w;
//   cov = sum(sw (c + d d^T)) / w - mean(d) mean(d)^T.
struct Moments {
  const float *w, *mx, *my, *c00, *c01, *c11;   // the sorted pool
  Merged out;
  size_t o;                                       // p * cap
  float rmx, rmy, s[kChannels];                   // pick mean and sums

  __device__ void begin(int pp) {
    rmx = mx[pp];
    rmy = my[pp];
#pragma unroll
    for (int k = 0; k < kChannels; ++k) s[k] = 0.f;
    add(pp);
  }

  __device__ void add(int j) {
    const float wj = w[j];
    const float dx = rmx - mx[j];
    const float dy = rmy - my[j];
    s[0] += wj;
    s[1] += wj * dx;
    s[2] += wj * dy;
    s[3] += wj * (c00[j] + dx * dx);
    s[4] += wj * (c01[j] + dx * dy);
    s[5] += wj * (c11[j] + dy * dy);
  }

  __device__ void store(int i) const {
    const float wsum = s[0];
    const bool live = wsum > 0.0f;
    const float inv = live ? 1.0f / fmaxf(wsum, 1e-38f) : 0.0f;
    const float mcx = s[1] * inv, mcy = s[2] * inv;
    const float n00 = s[3] * inv - mcx * mcx;
    const float n01 = s[4] * inv - mcx * mcy;
    const float n11 = s[5] * inv - mcy * mcy;
    out.w[o + i] = wsum;
    out.mx[o + i] = live ? rmx - mcx : 0.0f;
    out.my[o + i] = live ? rmy - mcy : 0.0f;
    out.c00[o + i] = live ? n00 : 1.0f;
    out.c01[o + i] = n01;
    out.c11[o + i] = live ? n11 : 1.0f;
  }

  __device__ void empty(int i) const {
    out.w[o + i] = 0.0f;
    out.mx[o + i] = 0.0f;
    out.my[o + i] = 0.0f;
    out.c00[o + i] = 1.0f;
    out.c01[o + i] = 0.0f;
    out.c11[o + i] = 1.0f;
  }
};

// The merge of particle p's pool, in pool (shared or device memory, Idx
// as merge_common.cuh says).
template <int kMetric, typename Idx>
__device__ __forceinline__ void merge_particle(const Pool& in,
                                               const Merged& out, int p,
                                               int K, int cap, float min_sep,
                                               float* pool) {
  const Books<Idx> b(pool, kChannels, K);
  float* s_w = pool;
  float* s_mx = s_w + K;
  float* s_my = s_mx + K;
  float* s_c00 = s_my + K;
  float* s_c01 = s_c00 + K;
  float* s_c11 = s_c01 + K;
  const size_t off = static_cast<size_t>(p) * K;

  const int L = phd_merge::presort<kThreads>(in.w + off, K, pool, b);
  {
    const float* src[kChannels] = {in.w + off,   in.mx + off,
                                   in.my + off,  in.c00 + off,
                                   in.c01 + off, in.c11 + off};
    phd_merge::stage<kThreads, kChannels>(src, K, pool, b);
  }

  Near<kMetric> test{s_mx, s_my, s_c00, s_c01, s_c11, min_sep};
  const int n = phd_merge::pick_loop<kThreads, kBatch>(test, L, cap, b);
  Moments acc{s_w,   s_mx,  s_my, s_c00,
              s_c01, s_c11, out,  static_cast<size_t>(p) * cap};
  phd_merge::moments<kThreads>(acc, L, n, cap, b);
}

template <int kMetric>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(Pool in, Merged out, int K, int cap, float min_sep) {
  extern __shared__ float pool[];   // [6][K]
  merge_particle<kMetric, unsigned short>(in, out, blockIdx.x, K, cap,
                                          min_sep, pool);
}

// A pool too wide for a CTA's shared memory: one pool per CTA in scratch
// (device memory), the CTAs striding over the particles.
template <int kMetric>
__global__ void __launch_bounds__(kThreads)
    merge_wide_kernel(Pool in, Merged out, int P, int K, int cap,
                      float min_sep, float* scratch) {
  float* pool = scratch + blockIdx.x *
                              phd_merge::wide_pool_floats(kChannels, K);
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    merge_particle<kMetric, unsigned>(in, out, p, K, cap, min_sep, pool);
    __syncthreads();                // the pool is the next particle's
  }
}

// per metric, the devices where the kernel's carveout is set
std::atomic<unsigned> g_carved[2];

}  // namespace

extern "C" {

// Floats of device-memory scratch a launch of P pools of K candidates
// takes: 0 while a pool fits a CTA's shared memory (K <= 7744 on an H100).
long long phd_merge_wide_floats(int P, int K) {
  if (P <= 0 || K <= 0 ||
      phd_merge::fits_shared(merge_kernel<0>,
                             phd_merge::smem_bytes(kChannels, K)))
    return 0;
  return phd_merge::wide_floats(kChannels, P, K);
}

// Pool channels are [P, K] row-major float32, outputs [P, cap]; scratch:
// phd_merge_wide_floats(P, K) floats of device memory (null when that is
// 0). Returns the launch's cudaError_t.
int phd_merge_launch(const float* w, const float* mx, const float* my,
                     const float* c00, const float* c01, const float* c11,
                     float* ow, float* omx, float* omy, float* o00,
                     float* o01, float* o11, int P, int K, int cap,
                     float min_sep, int metric, float* scratch,
                     void* stream) {
  if (P <= 0 || cap <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || (metric != 0 && metric != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Pool in{w, mx, my, c00, c01, c11};
  Merged out{ow, omx, omy, o00, o01, o11};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel = metric == 1 ? merge_kernel<1> : merge_kernel<0>;
  const size_t smem = phd_merge::smem_bytes(kChannels, K);
  if (!phd_merge::fits_shared(kernel, smem)) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const auto wide = metric == 1 ? merge_wide_kernel<1>
                                  : merge_wide_kernel<0>;
    wide<<<phd_merge::wide_ctas(P), kThreads, 0, st>>>(in, out, P, K, cap,
                                                       min_sep, scratch);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t e =
      phd_merge::allow_smem_max(kernel, smem, g_carved[metric]);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<P, kThreads, smem, st>>>(in, out, K, cap, min_sep);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the kernel (metric 0) that fit on one SM for a pool of K
// candidates.
int phd_merge_ctas_per_sm(int K) {
  return phd_merge::ctas_per_sm(merge_kernel<0>, kThreads,
                                phd_merge::smem_bytes(kChannels, K),
                                g_carved[0]);
}

}  // extern "C"

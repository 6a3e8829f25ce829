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
//      inf, NaN or a negative value, decided as the plain version decides);
//   3. write their moment match, in one pass centred on the pick:
//      w = sum sw;  mu = pick - sum(sw d) / w;
//      cov = sum(sw (c + d d^T)) / w - mean(d) mean(d)^T;
//   4. zero the selected weights.
// Unused slots hold w = 0, mean 0 and the identity covariance.
//
// What bounds it on an H100: the serial chain of picks; a candidate test
// is about 60 flops and one divide. The bytes (one read of the 10-channel
// pool, one write of the map) are small. The first design scanned
// all K candidates at every pick, dead and merged ones included, and ended
// each pick in a block reduction of 10 moment sums and an argmax: 3.37 ms
// on an H100 on the dense pool, against a 0.112 ms bound.
//
// Design (merge_common.cuh, the presorted design of merge.cu and
// merge4.cu): one CTA of kThreads threads per particle. The live
// candidates are sorted once by (w desc, index asc), the greedy pick order,
// and staged in shared memory in that order, so a pick never scans a dead
// candidate or the merged prefix. Picks go in batches of kBatch: one pass
// tests each unmerged candidate after the first pick against the batch
// picks before it (kBatch independent chains per thread, the picks' means
// and covariances in registers), the first near pick takes it, and the
// batch ends in one __syncthreads; a batch pick near an earlier one cuts
// the batch there. The test is the plain version's arithmetic, whole, with
// no early exit and no multiply-add contraction (each operation rounded on
// its own, in mahalanobis3's order), so it decides every candidate exactly
// as merge3_plain does; maybe() decides and confirm() is true. After the loop
// one warp threads each slot's members into a list in sorted order and one
// thread per slot sums the slot's moments along it, centred on the pick: a
// fixed order, no atomics on floats, the same result on every run (the
// order differs from the plain version's index order: rounding only).
//
// Shared memory: (4 * 10 + 6) = 46 B per candidate plus 64 B, 25.8 KB at
// the dense K = 560 and 22.9 KB at the shipped K = 496; the widest pool in
// shared memory is K = 5051 (232,410 B of the 232,448 a CTA may use). A
// wider one runs merge3_wide_kernel, the same code on a pool in device
// memory (52 B per candidate and CTA, 1024 CTAs at most): K is bounded by
// device memory alone. 72 registers and 7 CTAs per SM at K = 560 (on an
// H100; batch 8 took 119 registers and 4 CTAs and ran 30 % slower).

#include <cuda_runtime.h>

#include <atomic>

#include "merge_common.cuh"

namespace {

using phd_merge::Books;

constexpr int kThreads = 128;       // 64: 4 % slower, 256: 47 % slower
constexpr int kBatch = 4;           // picks per pass; 2: 5 %, 8: 30 % slower
constexpr int kChannels = 10;       // w, m0 m1 m2, c00 c01 c02 c11 c12 c22

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

// The neighbour test against the batch's picks, on the sorted pool
// (m [3][K], c [6][K]): dist < min_sep, as merge3_plain computes it.
struct Near3 {
  const float *m, *c;
  int K;
  float min_sep;
  float rm[kBatch][3], rc[kBatch][6];

  struct Cand {
    float m[3], c[6];
  };

  __device__ void pick(int j, int pos) {
#pragma unroll
    for (int k = 0; k < 3; ++k) rm[j][k] = m[k * K + pos];
#pragma unroll
    for (int q = 0; q < 6; ++q) rc[j][q] = c[q * K + pos];
  }

  __device__ Cand load(int p) const {
    Cand x;
#pragma unroll
    for (int k = 0; k < 3; ++k) x.m[k] = m[k * K + p];
#pragma unroll
    for (int q = 0; q < 6; ++q) x.c[q] = c[q * K + p];
    return x;
  }

  // Each product and sum rounded on its own, in mahalanobis3's order
  // (no multiply-add contraction): the float32 values merge3_plain
  // computes, so a near-singular or indefinite A is decided as it is there.
  __device__ bool maybe(int j, const Cand& x) const {
    float a[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) a[q] = mul(0.5f, add(rc[j][q], x.c[q]));
    const float a00 = a[0], a01 = a[1], a02 = a[2], a11 = a[3], a12 = a[4],
                a22 = a[5];
    const float i00 = sub(mul(a11, a22), mul(a12, a12));
    const float i01 = sub(mul(a02, a12), mul(a01, a22));
    const float i02 = sub(mul(a01, a12), mul(a02, a11));
    const float i11 = sub(mul(a00, a22), mul(a02, a02));
    const float i12 = sub(mul(a02, a01), mul(a00, a12));
    const float i22 = sub(mul(a00, a11), mul(a01, a01));
    const float det =
        add(sub(mul(a00, i00), mul(a01, sub(mul(a01, a22), mul(a12, a02)))),
            mul(a02, sub(mul(a01, a12), mul(a11, a02))));
    float d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = sub(rm[j][k], x.m[k]);
    const float diag = add(add(mul(mul(d[0], d[0]), i00),
                               mul(mul(d[1], d[1]), i11)),
                           mul(mul(d[2], d[2]), i22));
    const float off = add(add(mul(mul(d[0], d[1]), i01),
                              mul(mul(d[0], d[2]), i02)),
                          mul(mul(d[1], d[2]), i12));
    return __fdiv_rn(add(diag, mul(2.0f, off)), det) < min_sep;
  }

  __device__ static float mul(float x, float y) { return __fmul_rn(x, y); }
  __device__ static float add(float x, float y) { return __fadd_rn(x, y); }
  __device__ static float sub(float x, float y) { return __fsub_rn(x, y); }

  __device__ bool confirm(int, int) const { return true; }
};

// One slot's moment match, centred on its pick:
//   w = sum sw;  mu = pick - sum(sw d) / w;
//   cov = sum(sw (c + d d^T)) / w - mean(d) mean(d)^T.
struct Moments3 {
  const float *w, *m, *c;           // the sorted pool
  int K, cap;
  Merged3 out;
  size_t o;                         // p * cap
  float rm[3], s[kChannels];        // the slot's pick mean and sums

  __device__ void begin(int pp) {
#pragma unroll
    for (int k = 0; k < 3; ++k) rm[k] = m[k * K + pp];
#pragma unroll
    for (int k = 0; k < kChannels; ++k) s[k] = 0.f;
    add(pp);
  }

  __device__ void add(int j) {
    const float wj = w[j];
    float d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = rm[k] - m[k * K + j];
    s[0] += wj;
#pragma unroll
    for (int k = 0; k < 3; ++k) s[1 + k] += wj * d[k];
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int y = x; y < 3; ++y) {
        const int q = cov_index(x, y);
        s[4 + q] += wj * (c[q * K + j] + d[x] * d[y]);
      }
  }

  __device__ void store(int i) const {
    const float wsum = s[0];
    const bool live = wsum > 0.0f;
    const float inv = live ? 1.0f / fmaxf(wsum, 1e-38f) : 0.0f;
    float mc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) mc[k] = s[1 + k] * inv;
    out.ch[0][o + i] = wsum;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out.ch[1 + k][o + i] = live ? rm[k] - mc[k] : 0.0f;
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int y = x; y < 3; ++y) {
        const int q = cov_index(x, y);
        const float n = s[4 + q] * inv - mc[x] * mc[y];
        out.ch[4 + q][o + i] = (x == y && !live) ? 1.0f : n;
      }
  }

  __device__ void empty(int i) const {
#pragma unroll
    for (int ch = 0; ch < kChannels; ++ch)
      out.ch[ch][o + i] = (ch == 4 || ch == 7 || ch == 9) ? 1.0f : 0.0f;
  }
};

// The merge of particle p's pool, in pool (shared or device memory, Idx
// as merge_common.cuh says).
template <typename Idx>
__device__ __forceinline__ void merge3_particle(const Pool3& in,
                                                const Merged3& out, int p,
                                                int K, int cap, float min_sep,
                                                float* pool) {
  const Books<Idx> b(pool, kChannels, K);
  const size_t pk = static_cast<size_t>(p) * K;

  const int L = phd_merge::presort<kThreads>(in.ch[0] + pk, K, pool, b);
  {
    const float* src[kChannels];
#pragma unroll
    for (int ch = 0; ch < kChannels; ++ch) src[ch] = in.ch[ch] + pk;
    phd_merge::stage<kThreads, kChannels>(src, K, pool, b);
  }

  Near3 test{pool + K, pool + 4 * K, K, min_sep};
  const int n = phd_merge::pick_loop<kThreads, kBatch>(test, L, cap, b);
  Moments3 acc{pool, pool + K, pool + 4 * K, K, cap, out,
               static_cast<size_t>(p) * cap};
  phd_merge::moments<kThreads>(acc, L, n, cap, b);
}

__global__ void __launch_bounds__(kThreads)
    merge3_kernel(Pool3 in, Merged3 out, int K, int cap, float min_sep) {
  extern __shared__ float pool[];   // [10][K]: w, mean [3], cov [6]
  merge3_particle<unsigned short>(in, out, blockIdx.x, K, cap, min_sep,
                                  pool);
}

// A pool too wide for a CTA's shared memory: one pool per CTA in scratch
// (device memory), the CTAs striding over the particles.
__global__ void __launch_bounds__(kThreads)
    merge3_wide_kernel(Pool3 in, Merged3 out, int P, int K, int cap,
                       float min_sep, float* scratch) {
  float* pool = scratch + blockIdx.x *
                              phd_merge::wide_pool_floats(kChannels, K);
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    merge3_particle<unsigned>(in, out, p, K, cap, min_sep, pool);
    __syncthreads();                // the pool is the next particle's
  }
}

std::atomic<unsigned> g_carved{0};  // devices where the carveout is set

}  // namespace

extern "C" {

// Floats of device-memory scratch a launch of P pools of K candidates
// takes: 0 while a pool fits a CTA's shared memory (K <= 5051 on an H100).
long long phd_merge3_wide_floats(int P, int K) {
  if (P <= 0 || K <= 0 ||
      phd_merge::fits_shared(merge3_kernel,
                             phd_merge::smem_bytes(kChannels, K)))
    return 0;
  return phd_merge::wide_floats(kChannels, P, K);
}

// Pool: ten [P, K] row-major float32 channels (w, m0, m1, m2, c00, c01, c02,
// c11, c12, c22); outputs: the same ten channels, [P, cap]; scratch:
// phd_merge3_wide_floats(P, K) floats of device memory (null when that is
// 0). Returns the launch's cudaError_t.
int phd_merge3_launch(const float* w, const float* m0, const float* m1,
                      const float* m2, const float* c00, const float* c01,
                      const float* c02, const float* c11, const float* c12,
                      const float* c22, float* ow, float* om0, float* om1,
                      float* om2, float* o00, float* o01, float* o02,
                      float* o11, float* o12, float* o22, int P, int K,
                      int cap, float min_sep, float* scratch, void* stream) {
  if (P <= 0 || cap <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Pool3 in{{w, m0, m1, m2, c00, c01, c02, c11, c12, c22}};
  Merged3 out{{ow, om0, om1, om2, o00, o01, o02, o11, o12, o22}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = phd_merge::smem_bytes(kChannels, K);
  if (!phd_merge::fits_shared(merge3_kernel, smem)) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    merge3_wide_kernel<<<phd_merge::wide_ctas(P), kThreads, 0, st>>>(
        in, out, P, K, cap, min_sep, scratch);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t e =
      phd_merge::allow_smem_max(merge3_kernel, smem, g_carved);
  if (e != cudaSuccess) return static_cast<int>(e);
  merge3_kernel<<<P, kThreads, smem, st>>>(in, out, K, cap, min_sep);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the kernel that fit on one SM for a pool of K candidates, and its
// registers per thread in *regs.
int phd_merge3_ctas_per_sm(int K, int* regs) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, merge3_kernel) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  if (regs != nullptr) *regs = attr.numRegs;
  return phd_merge::ctas_per_sm(merge3_kernel, kThreads,
                                phd_merge::smem_bytes(kChannels, K), g_carved);
}

}  // extern "C"

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
// What bounds it on an H100: the bytes (one read of the pool, one write of
// the map) take 0.09 ms at the dense pool (8192 x 1088 -> 512); the rest is
// latency inside a CTA. On the benchmark's pools the gated chain below
// takes about three quarters of a particle's clock cycles (265k of 340k at
// dense8k, 65k of 99k at wide65k), most of it the passes, which read every
// later unmerged candidate once a batch; then the presort's bitonic sort
// (45k, 21k), the moments and the staging loads. pick_loop
// (merge_common.cuh, merge3 and merge4) would take ~70 batches of 8 picks
// a particle at the dense pools, testing each candidate against every
// earlier pick, where a candidate has about two neighbours.
//
// Design (merge_common.cuh, "the presorted design"): one CTA of kThreads
// threads per particle. The live candidates are sorted once by (w desc,
// index asc), the greedy pick order, and staged in shared memory in that
// order. The gated chain below takes the picks in batches of up to 32 and
// puts a reach gate before every exact test; after it one warp threads
// each slot's members into a list in sorted order and one thread per slot
// sums the slot's moments along it: a fixed order, no atomics on floats,
// the same result on every run. The metric is a template parameter, so no
// test branches on it.
//
// The gated chain gives pick_loop's picks, owners and member order, so the
// six outputs are pick_loop's bit for bit:
//   1. Reach and gate. rho_p bounds the largest eigenvalue of C_p (closed
//      form). Metric 0: a near pair has |d|^2 < min_sep lmax((C_q + C_p) /
//      2) <= min_sep (rho_q + rho_p) / 2; metric 1: 1 - dist <= exp(-d^T
//      (C_q + C_p)^-1 d / 4), so |d|^2 < -4 ln(1 - min_sep) (rho_q +
//      rho_p). The gate is that bound times (1 + kDelta) (metric 1 with
//      kHellingerSlack added to -ln(1 - min_sep) first), and the exact
//      test (earlier position as the pick, later as the candidate, as
//      pick_loop calls it) decides every pair inside it. A candidate is
//      unbounded, and passes every gate, where its mean or covariance is
//      not finite or out of [2^-40, 2^40], or its covariance not clearly
//      positive definite (lmin <= lmax / kappa: kKappa0, kKappa1); at
//      min_sep >= 1 - 2^-10 (metric 1), or min_sep outside [2^-30, 2^30]
//      (metric 0, positive), every candidate is. The mediant inequality
//      bounds cond((C_q + C_p) / 2) by the larger of the two, so on two
//      bounded candidates the float test's rounding stays far inside
//      kDelta (tests/test_torch_merge.py proves the gate on float32 pairs
//      at the edge of both tests).
//   2. Boxes. Each position's box, its mean +- sqrt(scale rho) (padded
//      for rounding), is cut to the columns and rows of a kGrid x kGrid
//      grid over the bounded means, once a particle (4 bits a bound, in
//      books.head, idle until link_members). A pair inside the gate has
//      |d| < sqrt(scale rho_q) + sqrt(scale rho_p), so its boxes meet; an
//      unbounded position's box is the whole grid.
//   3. A batch is the next g <= 32 unmerged positions q_0 < ... < q_{g-1};
//      no earlier pick is near any of them. Every warp finds it alike, lane
//      k holding q_k, and ballots per column and row which boxes start at
//      or before it and which end at or after it: a box of columns c0 ..
//      c1 meets those that start by c1 and end from c0, so the positions
//      whose boxes meet a box are four table reads. The warp resolves the
//      batch in registers: q_k is a pick where no earlier pick of the
//      batch is near it, else taken by the earliest one that is; the first
//      cap - n picks are kept (the chain stops there, and what only a later
//      pick took stays unmerged).
//   4. A pass takes every unmerged position after q_{g-1}, the kept picks
//      whose boxes meet its box, in order, the gate, then the exact test:
//      the first near one takes it. Then the CTA's one barrier of the
//      batch, after which warp 0 writes the batch's own slots and owners.
// So the chain costs ~L / 25 batches, not ~L / 8, none cut short, and a
// pick whose box misses a candidate's costs nothing. A stats pointer (null
// on the main paths) selects a build of the kernel that counts, per
// particle, the batches, the gate tests, the exact tests and the unbounded
// candidates; without one no count is compiled in. Every launch with stats
// writes the live candidates and the slots filled too.
//
// Shared memory: (4 * 6 + 6) = 30 B per candidate plus 4.1 KB of the gated
// chain's tables, 36 KB at the dense K = 1088 (6 CTAs on an SM); the
// widest pool the gated chain takes in shared memory is K = 7609 (227 KB).
// From K = 7610 to 7744 the tables no longer fit beside the pool, and the
// kernel runs pick_loop instead (112 B beside the pool); a wider pool runs
// merge_wide_kernel, pick_loop on a pool in device memory (36 B per
// candidate and CTA, 1024 CTAs at most), where the gated chain's passes
// were slower: K is bounded by device memory alone. The choice follows K
// alone, and every path gives the same bits; on the pick_loop paths the
// stats' four chain counts read -1.

#include <cuda_runtime.h>

#include <atomic>

#include "merge_common.cuh"

namespace {

using phd_merge::Books;
using phd_merge::kFull;

constexpr int kThreads = 128;       // 256: 1.4x slower on an H100
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;           // pick_loop's picks per pass
constexpr int kChannels = 6;        // w, mx, my, c00, c01, c11

// The gate (header, 1): its margin, the condition numbers of a bounded
// covariance, metric 1's slack and largest min_sep, metric 0's min_sep
// range, the range of a bounded mean and reach, and the pads of a box
// (header, 2).
constexpr float kDelta = 1.0f / 16.0f;
constexpr float kKappa0 = 16384.0f;
constexpr float kKappa1 = 128.0f;
constexpr float kHellingerSlack = 1.0f / 32.0f;
constexpr float kHellingerMaxSep = 1.0f - 1.0f / 1024.0f;
constexpr float kSepMax = 1073741824.0f;            // 2^30
constexpr float kBig = 1099511627776.0f;            // 2^40
constexpr float kReachPad = 1.0f / 1024.0f;
constexpr float kCoordPad = 1.0f / 65536.0f;
// the grid over a particle's bounded means: kGrid columns and rows; a
// position's box as 4-bit column and row bounds (x from | x to << 4 | y
// from << 8 | y to << 12): kAllCells for an unbounded one, kNoCells (an
// empty range) where no grid is drawn
constexpr int kGrid = 16;
constexpr unsigned kAllCells = 0xf0f0u, kNoCells = 0x0101u;
constexpr int kStats = 6;

struct Pool {
  const float *w, *mx, *my, *c00, *c01, *c11;
};

struct Merged {
  float *w, *mx, *my, *c00, *c01, *c11;
};

// A candidate as the neighbour test reads it.
struct Cand {
  float mx, my, c00, c01, c11;
};

// The neighbour test of candidate x against a pick (mean rmx, rmy;
// covariance r00, r01, r11), for metric kMetric: the float expressions
// pick_loop's test has always evaluated.
template <int kMetric>
__device__ __forceinline__ bool near_pick(float min_sep, float rmx,
                                          float rmy, float r00, float r01,
                                          float r11, const Cand& x) {
  const float dx = rmx - x.mx;
  const float dy = rmy - x.my;
  if (kMetric == 1) {
    const float s00 = r00 + x.c00, s01 = r01 + x.c01, s11 = r11 + x.c11;
    const float det_sum = s00 * s11 - s01 * s01;
    const float safe = fmaxf(det_sum, 1.17549435e-38f);
    const float eps_q =
        -0.25f * (dx * dx * s11 - 2.0f * dx * dy * s01 + dy * dy * s00) /
        safe;
    const float det_prod =
        (r00 * x.c00 + r01 * x.c01) * (r01 * x.c01 + r11 * x.c11) -
        (r00 * x.c01 + r01 * x.c11) * (r01 * x.c00 + r11 * x.c01);
    const float dist =
        1.0f -
        sqrtf(fmaxf(sqrtf(fmaxf(det_prod, 0.0f)) / (det_sum / 4.0f), 0.0f)) *
            expf(eps_q);
    return dist < min_sep;
  }
  const float a00 = 0.5f * (r00 + x.c00);
  const float a01 = 0.5f * (r01 + x.c01);
  const float a11 = 0.5f * (r11 + x.c11);
  const float det = a00 * a11 - a01 * a01;
  const float quad = dx * dx * a11 - 2.0f * (dx * dy) * a01 + dy * dy * a00;
  return quad < min_sep * det;
}

// The gated chain's test: one pick at a time, on the sorted pool.
template <int kMetric>
struct Near {
  const float *mx, *my, *c00, *c01, *c11;
  float min_sep;
  float rmx, rmy, r00, r01, r11;      // the pick

  __device__ void pick(float x, float y, float a00, float a01, float a11) {
    rmx = x;
    rmy = y;
    r00 = a00;
    r01 = a01;
    r11 = a11;
  }

  __device__ Cand load(int p) const {
    return {mx[p], my[p], c00[p], c01[p], c11[p]};
  }

  __device__ bool maybe(const Cand& x) const {
    return near_pick<kMetric>(min_sep, rmx, rmy, r00, r01, r11, x);
  }
};

// pick_loop's test: the kBatch picks of a batch in registers. The test is
// cheap and exact, so maybe() is the whole of it.
template <int kMetric>
struct BatchNear {
  const float *mx, *my, *c00, *c01, *c11;
  float min_sep;
  float rmx[kBatch], rmy[kBatch], r00[kBatch], r01[kBatch], r11[kBatch];

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
    return near_pick<kMetric>(min_sep, rmx[j], rmy[j], r00[j], r01[j],
                              r11[j], x);
  }

  __device__ bool confirm(int, int) const { return true; }
};

// The gate's factor: a pair of bounded candidates can be near only where
// |d|^2 < scale (rho_q + rho_p). NaN where no candidate is bounded.
template <int kMetric>
__device__ __forceinline__ float gate_scale(float min_sep) {
  const float nan = __int_as_float(0x7fc00000);
  if (kMetric == 1)
    return min_sep <= kHellingerMaxSep
               ? 4.0f * (kHellingerSlack - log1pf(-min_sep)) *
                     (1.0f + kDelta)
               : nan;
  const bool ok = fabsf(min_sep) <= kSepMax &&
                  !(min_sep > 0.0f && min_sep < 1.0f / kSepMax);
  return ok ? 0.5f * min_sep * (1.0f + kDelta) : nan;
}

// A candidate's reach: the largest eigenvalue of its covariance, or -1
// where the candidate is unbounded (header, 1).
__device__ __forceinline__ float reach(float mx, float my, float c00,
                                       float c01, float c11, float kappa) {
  const float half = 0.5f * (c00 + c11);
  const float diff = 0.5f * (c00 - c11);
  const float lmax = half + sqrtf(diff * diff + c01 * c01);
  const float det = c00 * c11 - c01 * c01;
  const bool bounded = fabsf(mx) <= kBig && fabsf(my) <= kBig &&
                       c00 > 0.0f && c11 > 0.0f && lmax >= 1.0f / kBig &&
                       lmax <= kBig && det * kappa > lmax * lmax;
  return bounded ? lmax : -1.0f;
}

// The grid index of coordinate v: monotone in v, clamped to [0, kGrid).
__device__ __forceinline__ int grid_index(float v, float lo, float inv_h) {
  return static_cast<int>(fminf(fmaxf((v - lo) * inv_h, 0.0f),
                                static_cast<float>(kGrid - 1)));
}

// The position of the k-th (from 0) set bit of m, which has more than k.
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int low = __popc(m & ((1u << w) - 1u));
    if (k >= low) {
      k -= low;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// What a thread counts of one particle's chain (alike in every thread but
// the tests, which warp 0 counts in a batch's resolution), where the launch
// has a stats pointer.
struct GateCount {
  int batches, gate_tests, exact_tests, unbounded;
};

// The gated chain (header): the greedy chain in batches of up to 32
// positions. Every warp finds the batch alike and resolves it alike (lane k
// holds position q_k); warp 0 writes what it decided. Fills b.pick and
// b.owner as pick_loop does and returns the slots filled, published by its
// last barrier. With kCount it counts into c; without, no count is
// compiled in.
template <int kMetric, bool kCount, typename Idx>
__device__ __forceinline__ int gated_chain(Near<kMetric>& test, int L,
                                           int cap, float min_sep,
                                           const Books<Idx>& b,
                                           GateCount& c) {
  constexpr Idx kFree = phd_merge::free_idx<Idx>();
  // per warp, the batch's positions (mean, reach (-1: unbounded), c00;
  // c01, c11) and their boxes' column and row bounds as bit masks
  __shared__ float4 s_batch[kWarps][32];
  __shared__ float2 s_cov[kWarps][32];
  __shared__ unsigned s_span[kWarps][4][kGrid];
  __shared__ float s_box[kWarps][4];
  const float* mx = test.mx;
  const float* my = test.my;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  const float scale = gate_scale<kMetric>(min_sep);
  const bool gated = scale == scale;
  const float kappa = kMetric == 1 ? kKappa1 : kKappa0;
  auto rho = [&](int p) {
    return gated ? reach(mx[p], my[p], test.c00[p], test.c01[p],
                         test.c11[p], kappa)
                 : -1.0f;
  };
  // the gate: whether the exact test of a pick (x, y, reach r) and a
  // candidate can hold
  auto inside = [&](float x, float y, float r, float px, float py,
                    float pr) {
    const float dx = x - px, dy = y - py;
    return r < 0.0f || pr < 0.0f || dx * dx + dy * dy < scale * (r + pr);
  };
  // the exact test of the batch's position k (the pick) and a candidate
  auto near = [&](int k, const Cand& x) {
    const float4 a = s_batch[warp][k];
    const float2 b = s_cov[warp][k];
    test.pick(a.x, a.y, a.w, b.x, b.y);
    return test.maybe(x);
  };
  c = GateCount{0, 0, 0, 0};

  // the box of the bounded means, and the grid over it: a pair inside the
  // gate lies in boxes of half-width sqrt(scale rho) around each (|d| <
  // sqrt(scale (rho_q + rho_p)) <= sqrt(scale rho_q) + sqrt(scale
  // rho_p)), padded for rounding, and two boxes that meet share a cell
  float x0 = __int_as_float(0x7f800000), x1 = -x0, y0 = x0, y1 = -x0;
  for (int p = t; p < L; p += kThreads) {
    const float r = rho(p);
    if (kCount) c.unbounded += r < 0.0f;
    if (r > 0.0f) {
      x0 = fminf(x0, mx[p]);
      x1 = fmaxf(x1, mx[p]);
      y0 = fminf(y0, my[p]);
      y1 = fmaxf(y1, my[p]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(kFull, x0, o));
    x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, o));
    y0 = fminf(y0, __shfl_xor_sync(kFull, y0, o));
    y1 = fmaxf(y1, __shfl_xor_sync(kFull, y1, o));
  }
  if (lane == 0) {
    s_box[warp][0] = x0;
    s_box[warp][1] = x1;
    s_box[warp][2] = y0;
    s_box[warp][3] = y1;
  }
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    x0 = fminf(x0, s_box[w][0]);
    x1 = fmaxf(x1, s_box[w][1]);
    y0 = fminf(y0, s_box[w][2]);
    y1 = fmaxf(y1, s_box[w][3]);
  }
  // with no bounded candidate (or none that can be near) no cell is used
  const bool grid = scale > 0.0f && x0 <= x1;
  const float inv_hx = grid && x1 > x0 ? kGrid / (x1 - x0) : 0.0f;
  const float inv_hy = grid && y1 > y0 ? kGrid / (y1 - y0) : 0.0f;
  const float span = grid ? fabsf(x0) + fabsf(x1) + fabsf(y0) + fabsf(y1)
                          : 0.0f;
  const float root = sqrtf(fmaxf(scale, 0.0f));
  // per position, in b.head (read no more until link_members): its box's
  // cell bounds (kGrid)
  for (int p = t; p < L; p += kThreads) {
    const float r = rho(p);
    unsigned code = r < 0.0f ? kAllCells : kNoCells;
    if (grid && r > 0.0f) {
      const float x = mx[p], y = my[p];
      const float hw = root * sqrtf(r) * (1.0f + kReachPad) +
                       kCoordPad * (fabsf(x) + fabsf(y) + span);
      code = grid_index(x - hw, x0, inv_hx) |
             grid_index(x + hw, x0, inv_hx) << 4 |
             grid_index(y - hw, y0, inv_hy) << 8 |
             grid_index(y + hw, y0, inv_hy) << 12;
    }
    b.head[p] = static_cast<Idx>(code);
  }
  __syncthreads();

  int n = 0, from = 0;
  while (n < cap) {
    // the next g <= 32 unmerged positions, alike in every warp: lane k
    // holds q_k (nothing writes a position up to q_{g-1} before the
    // batch's barrier)
    int g = 0, q = 0;
    for (int base = from; base < L && g < 32; base += 32) {
      const int p = base + lane;
      const unsigned m = __ballot_sync(kFull, p < L && b.owner[p] == kFree);
      const int k = lane - g;
      if (k >= 0 && k < __popc(m)) q = base + nth_bit(m, k);
      g = min(32, g + __popc(m));
    }
    if (g == 0) break;
    if (kCount) ++c.batches;
    const bool in = lane < g;
    const unsigned batch = g == 32 ? kFull : (1u << g) - 1u;
    Cand qc{};
    float qr = -1.0f;
    unsigned qcode = kNoCells;
    if (in) {
      qc = test.load(q);
      qr = rho(q);
      qcode = b.head[q];
      s_batch[warp][lane] = make_float4(qc.mx, qc.my, qr, qc.c00);
      s_cov[warp][lane] = make_float2(qc.c01, qc.c11);
    }
    // per grid column i, the batch positions whose boxes start at or before
    // it and those that end at or after it; the same per row (an unbounded
    // position spans all). Boxes are intervals of columns and rows, so the
    // positions whose boxes meet columns c0 .. c1 are those that start at
    // or before c1 and end at or after c0.
    const unsigned always = __ballot_sync(kFull, in && qcode == kAllCells);
#pragma unroll
    for (int i = 0; i < kGrid; ++i) {
      const unsigned from_x = __ballot_sync(kFull, in && (qcode & 15u) <= i);
      const unsigned to_x =
          __ballot_sync(kFull, in && (qcode >> 4 & 15u) >= i);
      const unsigned from_y =
          __ballot_sync(kFull, in && (qcode >> 8 & 15u) <= i);
      const unsigned to_y = __ballot_sync(kFull, in && (qcode >> 12) >= i);
      if (lane == i) {
        s_span[warp][0][i] = from_x;
        s_span[warp][1][i] = to_x;
        s_span[warp][2][i] = from_y;
        s_span[warp][3][i] = to_y;
      }
    }
    __syncwarp();
    // the batch positions whose boxes may meet the box of code
    auto reachable = [&](unsigned code) {
      if (code == kAllCells) return batch;
      if (code == kNoCells) return always;
      const unsigned(&sp)[4][kGrid] = s_span[warp];
      return (sp[0][code >> 4 & 15u] & sp[1][code & 15u] &
              sp[2][code >> 12] & sp[3][code >> 8 & 15u]) |
             always;
    };
    // nearby: bit j set where q_j (as the pick) is near q_lane, j < lane
    unsigned nearby = 0;
    if (in) {
      for (unsigned m = reachable(qcode) & below; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const float4 jq = s_batch[warp][j];
        if (kCount) c.gate_tests += warp == 0;
        if (inside(jq.x, jq.y, jq.z, qc.mx, qc.my, qr)) {
          if (kCount) c.exact_tests += warp == 0;
          if (near(j, qc)) nearby |= 1u << j;
        }
      }
    }
    // the picks: q_k is one where no earlier pick of the batch is near it
    // (earlier batches' picks took what they were near), settled in order
    // over the positions that have a near one; the first cap - n are kept,
    // as where the chain stops
    unsigned picks = __ballot_sync(kFull, in && nearby == 0);
    for (unsigned m = __ballot_sync(kFull, nearby != 0); m; m &= m - 1) {
      const int k = __ffs(m) - 1;
      if ((__shfl_sync(kFull, nearby, k) & picks) == 0) picks |= 1u << k;
    }
    unsigned kept = picks;
    while (__popc(kept) > cap - n) kept &= ~(0x80000000u >> __clz(kept));
    // q_lane's slot: its own where kept, the earliest near pick's where
    // that one is kept, else none
    const bool mine = (kept >> lane) & 1u;
    const unsigned by = nearby & picks;
    int slot = -1;
    if (in && mine)
      slot = n + __popc(kept & below);
    else if (in && by != 0 && ((kept >> (__ffs(by) - 1)) & 1u))
      slot = n + __popc(kept & ((1u << (__ffs(by) - 1)) - 1u));
    // every unmerged position after the batch against the kept picks whose
    // cells it may reach, in order: the gate, then the exact test; the
    // first near one takes it
    const int qlast = __shfl_sync(kFull, q, g - 1);
    for (int p = qlast + 1 + t; p < L; p += kThreads) {
      if (b.owner[p] != kFree) continue;
      unsigned maybe = reachable(b.head[p]) & kept;
      if (maybe == 0) continue;
      const Cand pc = test.load(p);
      const float pr = gated ? reach(pc.mx, pc.my, pc.c00, pc.c01, pc.c11,
                                     kappa)
                             : -1.0f;
      for (; maybe; maybe &= maybe - 1) {
        const int k = __ffs(maybe) - 1;
        const float4 kq = s_batch[warp][k];
        if (kCount) ++c.gate_tests;
        if (!inside(kq.x, kq.y, kq.z, pc.mx, pc.my, pr)) continue;
        if (kCount) ++c.exact_tests;
        if (near(k, pc)) {
          b.owner[p] = static_cast<Idx>(n + __popc(kept & ((1u << k) - 1u)));
          break;
        }
      }
    }
    n += __popc(kept);
    from = qlast + 1;
    __syncthreads();
    // the batch's own positions, now that no warp scans them (warp 0)
    if (warp == 0 && slot >= 0) {
      if (mine)
        b.pick[slot] = static_cast<Idx>(q);
      else
        b.owner[q] = static_cast<Idx>(slot);
    }
  }
  // as in pick_loop: no warp relinks owner while another still scans it
  __syncthreads();
  return n;
}

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

// How a kernel takes the pick chain: pick_loop's batches of kBatch, the
// gated chain, or the gated chain with its counts (a launch with a stats
// pointer).
enum Chain { kBatched, kGated, kCounted };

// The merge of particle p's pool, in pool (shared or device memory, Idx
// as merge_common.cuh says), by the chain kChain; stats, when not null,
// takes the chain's counts (header) at stats[kStats p ..]: -1 for the
// four the batched chain does not count.
template <int kMetric, Chain kChain, typename Idx>
__device__ __forceinline__ void merge_particle(const Pool& in,
                                               const Merged& out, int p,
                                               int K, int cap, float min_sep,
                                               float* pool, int* stats) {
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

  int n;
  GateCount c{-1, -1, -1, -1};
  if constexpr (kChain == kBatched) {
    BatchNear<kMetric> test{s_mx, s_my, s_c00, s_c01, s_c11, min_sep};
    n = phd_merge::pick_loop<kThreads, kBatch>(test, L, cap, b);
  } else {
    Near<kMetric> test{s_mx, s_my, s_c00, s_c01, s_c11, min_sep};
    n = gated_chain<kMetric, kChain == kCounted>(test, L, cap, min_sep, b,
                                                 c);
  }
  if constexpr (kChain == kCounted) {
    __shared__ int s_sum[3];
    if (threadIdx.x < 3) s_sum[threadIdx.x] = 0;
    __syncthreads();
    atomicAdd(&s_sum[0], c.gate_tests);
    atomicAdd(&s_sum[1], c.exact_tests);
    atomicAdd(&s_sum[2], c.unbounded);
    __syncthreads();
    c = GateCount{c.batches, s_sum[0], s_sum[1], s_sum[2]};
  }
  if (kChain != kGated && stats != nullptr && threadIdx.x == 0) {
    int* o = stats + static_cast<size_t>(p) * kStats;
    o[0] = c.batches;
    o[1] = c.gate_tests;
    o[2] = c.exact_tests;
    o[3] = c.unbounded;
    o[4] = L;
    o[5] = n;
  }
  Moments acc{s_w,   s_mx,  s_my, s_c00,
              s_c01, s_c11, out,  static_cast<size_t>(p) * cap};
  phd_merge::moments<kThreads>(acc, L, n, cap, b);
}

template <int kMetric, Chain kChain>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(Pool in, Merged out, int K, int cap, float min_sep,
                 int* stats) {
  extern __shared__ float pool[];   // [6][K], books
  merge_particle<kMetric, kChain, unsigned short>(in, out, blockIdx.x, K,
                                                  cap, min_sep, pool, stats);
}

// A pool too wide for a CTA's shared memory: one pool per CTA in scratch
// (device memory), the CTAs striding over the particles, on pick_loop's
// chain (the gated chain's passes, reading device memory, are slower).
template <int kMetric>
__global__ void __launch_bounds__(kThreads)
    merge_wide_kernel(Pool in, Merged out, int P, int K, int cap,
                      float min_sep, float* scratch, int* stats) {
  float* pool = scratch + blockIdx.x *
                              phd_merge::wide_pool_floats(kChannels, K);
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    merge_particle<kMetric, kBatched, unsigned>(in, out, p, K, cap, min_sep,
                                                pool, stats);
    __syncthreads();                // the pool is the next particle's
  }
}

using Kernel = void (*)(Pool, Merged, int, int, float, int*);

template <int kMetric>
Kernel kernel_of(Chain chain) {
  return chain == kBatched ? merge_kernel<kMetric, kBatched>
         : chain == kGated ? merge_kernel<kMetric, kGated>
                           : merge_kernel<kMetric, kCounted>;
}

Kernel kernel_of(int metric, Chain chain) {
  return metric == 1 ? kernel_of<1>(chain) : kernel_of<0>(chain);
}

// The shared-memory kernel's chain for a pool of K candidates: the gated
// one (kCounted where counted) while its tables fit beside the pool, else
// pick_loop's; -1 where the pool takes device memory.
int shared_chain(int metric, int K, bool counted) {
  const size_t smem = phd_merge::smem_bytes(kChannels, K);
  const Chain gated = counted ? kCounted : kGated;
  if (phd_merge::fits_shared(kernel_of(metric, gated), smem)) return gated;
  if (phd_merge::fits_shared(kernel_of(metric, kBatched), smem))
    return kBatched;
  return -1;
}

// per metric and chain, the devices where the kernel's carveout is set
std::atomic<unsigned> g_carved[2][3];

}  // namespace

extern "C" {

// Floats of device-memory scratch a launch of P pools of K candidates
// takes: 0 while a pool fits a CTA's shared memory (K <= 7744 on an H100).
long long phd_merge_wide_floats(int P, int K) {
  if (P <= 0 || K <= 0 || shared_chain(0, K, false) >= 0) return 0;
  return phd_merge::wide_floats(kChannels, P, K);
}

// Pool channels are [P, K] row-major float32, outputs [P, cap]; scratch:
// phd_merge_wide_floats(P, K) floats of device memory (null when that is
// 0); stats: null, or [P, 6] int32 that take the chain's counts (header).
// Returns the launch's cudaError_t.
int phd_merge_launch(const float* w, const float* mx, const float* my,
                     const float* c00, const float* c01, const float* c11,
                     float* ow, float* omx, float* omy, float* o00,
                     float* o01, float* o11, int P, int K, int cap,
                     float min_sep, int metric, float* scratch, int* stats,
                     void* stream) {
  if (P <= 0 || cap <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || (metric != 0 && metric != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Pool in{w, mx, my, c00, c01, c11};
  Merged out{ow, omx, omy, o00, o01, o11};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chain = shared_chain(metric, K, stats != nullptr);
  if (chain < 0) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const auto wide = metric == 1 ? merge_wide_kernel<1>
                                  : merge_wide_kernel<0>;
    wide<<<phd_merge::wide_ctas(P), kThreads, 0, st>>>(
        in, out, P, K, cap, min_sep, scratch, stats);
    return static_cast<int>(cudaGetLastError());
  }
  const Kernel kernel = kernel_of(metric, static_cast<Chain>(chain));
  const size_t smem = phd_merge::smem_bytes(kChannels, K);
  const cudaError_t e =
      phd_merge::allow_smem_max(kernel, smem, g_carved[metric][chain]);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<P, kThreads, smem, st>>>(in, out, K, cap, min_sep, stats);
  return static_cast<int>(cudaGetLastError());
}

// CTAs on one SM of the kernel (metric 0, no stats) that a pool of K
// candidates takes in shared memory; 0 where it takes device memory.
int phd_merge_ctas_per_sm(int K) {
  const int chain = shared_chain(0, K, false);
  if (chain < 0) return 0;
  return phd_merge::ctas_per_sm(kernel_of(0, static_cast<Chain>(chain)),
                                kThreads, phd_merge::smem_bytes(kChannels, K),
                                g_carved[0][chain]);
}

}  // extern "C"

// The two Jacobi forward auctions of the port, hand-written for Hopper
// (sm_90a): FastSLAM's joint data association whole (clamp, rounds and
// column readout of every particle in one launch), and the in-loop OSPA's
// square eps-scaled auction (every phase and the clean-up in one launch).
//
// ---------------------------------------------------------------------
// FastSLAM's association (assign_kernel).
//
// Replaces phdslam_tpu/filter/fastslam.py::_auction_rows under jax.vmap
// (not a Pallas kernel: XLA runs the rounds as a device loop whose trip
// count depends on the data; in PyTorch such a loop could only end by
// reading a flag on the host every round). What it computes, per particle
// p, from the raw benefit [M, F] (rows the measurements, columns the
// features, gated-out pairs at _NEG = -1e30) and the private value pv
// (log kappa as float32): the full benefit is [M, C], C = F + M, whose
// column F + m holds pv for row m and _NEG for every other row (never
// materialised here). Then, as JAX and kernels/auction.py::
// auction_assign_plain do:
//   0. the clamp: live = benefit > _NEG / 2 (NaN is not live); hi and lo
//      the largest and smallest live values (0 where there is none); span
//      = max(hi - lo, 1); floor = (lo - 4 span) - 1; eps = 1e-3 span;
//      every entry that is not live becomes floor;
//   1. rounds from zero prices, no column owned: every unassigned row m
//      takes values = benefit[m] - price, j the first column of the
//      largest value (a NaN counts as the largest), v1 its value and v2 the
//      largest value over the other columns (NaN if one is NaN, -inf if
//      there is none), v2 replaced by v1 where it is not finite, and bids
//      (v1 - v2) + eps on column j; a column whose largest bid is finite
//      (no NaN and no +inf among its bids) goes to the lowest row among its
//      largest bids: price += bid, owner = that row, and the row that owned
//      it before is unassigned; the rounds end when every row is assigned,
//      or at the budget;
//   2. the readout: each row's column is the lowest column it owns; a row
//      left unassigned takes its best column among those only it can win
//      (live for it and for no other row), the first of equals, 0 if none.
// Outputs: col [P, M] and the rounds run per particle, iters [P]. Each
// rounding is PyTorch's (the scalars cast to float32 first; 4 span, then
// lo - that, then - 1; no multiply that nvcc could contract), so col and
// iters equal the plain version's bit for bit.
//
// Bound on this card: the benefit read once, 4 P M F bytes (1 GiB at
// [8192, 64, 512], 0.32 ms at 3.35 TB/s). Design: one CTA of 8 warps per
// particle; the state (price, owner and the bid keys over C, the rows'
// round-1 statistics; 9.5 KiB at C = 576) lives in shared memory, so many
// CTAs share an SM, and the benefit stays in device memory. One pass over
// the particle's rows (16-byte loads, four in flight a lane) computes the
// clamp's hi and lo and, per row, its best live value and column, its
// second-best live value and where its first not-live column is: after the
// particle-wide reduction that is round 1 (prices 0, every row bidding)
// without a second read. Later rounds, where only outbid rows bid, read
// those rows again (from L2 mostly) and clamp them as they are read. The
// readout runs in the kernel; the live count per feature column, which
// only the fallback needs, is counted only when a particle ends at the
// budget with a row unassigned. A state too large for shared memory (C in
// the tens of thousands) lives in a device-memory slice per CTA, and the
// CTAs stride over the particles.
//
// A warp scans one bidding row: each lane keeps the top two of its
// columns as order-preserving integer keys of the values (a NaN above
// every number, -0 as +0), then three warp reductions (__reduce_max_sync,
// __reduce_min_sync) give the row's best column and its second-best value;
// float compares through five shuffle rounds (the first design) made a chain
// several times longer, the most of a round's latency.
//
// Each column resolves its bids with a 64-bit atomicMax on a key (the
// bid's bits in an order-preserving unsigned form) << 32 | (0xffffffff -
// row): the largest bid wins, the lowest row among equal ones. A NaN or
// +inf bid sets the top word to 0xffffffff, which never wins; -0 is keyed
// as +0. Ownership changes only where a column is won, so assigned is kept
// up to date there (a bidder owns nothing and an owner does not bid, so no
// row is touched twice in a round). Two barriers a round.
//
// ---------------------------------------------------------------------
// The square eps-scaled auction of the in-loop OSPA (square_kernel).
//
// Replaces phdslam_tpu/ops/ospa.py::_auction_assign (not a Pallas kernel:
// a lax.while_loop of rounds inside a lax.scan over the eps phases; a loop
// of PyTorch ops could end each phase only by reading the device every
// round). What it computes, per problem b, from cost [n, n] (in [0, 1]:
// ops/ospa.py divides by c^p) and the eps schedule eps [n_phases]: prices
// start at 0 and carry from one phase to the next; each phase starts with
// no column owned and no row assigned and runs the rounds above on the
// benefit -cost with that phase's eps, until every row is assigned or at
// the budget (the rounds of one phase); then the clean-up pairs the rows
// the last phase left unassigned with the columns it left unowned, the
// k-th such row (in index order) with the k-th such column. Outputs owner
// [B, n] (every column owned) and the rounds of each phase, iters [B,
// n_phases]. -cost - price is what JAX computes (benefit = -cost, then
// benefit - price), and nothing is multiplied, so the owners and the
// rounds equal kernels/auction.py::auction_square_plain's bit for bit.
//
// Bound on this card: the rounds, not the bytes. A problem runs thousands
// of rounds (about 3,200 over the 5 phases at n = 256) and each is a chain
// of dependent steps: the bidders' scans, a barrier, the resolution, a
// barrier. Design: one CTA of up to 32 warps per problem; row m belongs to
// warp m % 32 (slot m / 32), so a round's few bidders rarely queue on one
// warp (ranking the unassigned rows each round to spread them evenly was
// measured slower: its ballots cost more than the queueing). The cost
// stays on chip: in shared memory up to n = 237 (4 n^2 bytes beside the
// state), and above that, up to n = 256, the last two row slots of every
// warp (64 rows) in registers, 8 values a lane, the other rows in shared
// memory (192 KiB at n = 256). A lane's n / 32 values (8 at most) are
// loaded unrolled before the reduction, so their loads are in flight
// together. Each round records the columns that got a bid (the first
// bidder of a column appends it to a list) and resolves only those; the
// list alternates by round parity, so its count is cleared without a
// barrier of its own. Past n = 256 the cost is read from device memory,
// and past ~8,000 columns the state moves to device-memory scratch. A
// barrier after each phase's rounds keeps a thread from resetting the
// state while another still reads the count of unassigned rows. The
// clean-up is
// one thread's pass over the columns (O(n), once a launch).

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "merge_common.cuh"

namespace {

constexpr int kThreads = 256;               // the FastSLAM kernel's CTA
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;                   // 16-byte loads in flight a lane
constexpr int kSquareWarps = 32;            // the square kernel's most warps
constexpr int kRegSlots = 2;                // register row slots a warp
constexpr int kRegCols = 8;                 // values a lane: n <= 256
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kPoison = 0xffffffffu;   // key top word: NaN or +inf bid
constexpr unsigned kNegInf = 0x007fffffu;   // key top word of a -inf bid
constexpr int kWideCtas = 1024;             // grid of the scratch paths
// _NEG / 2 and _EPS_FINAL as PyTorch casts the Python scalars: the double,
// rounded to float32
constexpr float kLiveAbove = static_cast<float>(-1e30 / 2);
constexpr float kEpsFinal = static_cast<float>(1e-3);

__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

// A value's order-preserving key: larger values have larger keys, every
// NaN the largest (0xffffffff, equal to each other), -0 keyed as +0. 0 is
// no value's key (a negative NaN would have it): "nothing".
__device__ __forceinline__ unsigned value_key(float v) {
  if (isnan(v)) return 0xffffffffu;
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The value of a key: NaN for 0xffffffff, -inf for nothing (0).
__device__ __forceinline__ float key_value(unsigned k) {
  if (k == 0xffffffffu) return __int_as_float(0x7fc00000);
  if (k == 0u) return -INFINITY;
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The best of a set of (value, column): k1 the largest key (a NaN before
// every number), j its column, the lowest among equal keys, and k2 the
// largest key over the other columns (0 if there is none). Its v2 is
// jnp.max / torch.amax over the other values: NaN if one is NaN; a -0
// read as +0 changes no bid, since eps > 0 is added to v1 - v2.
struct Top2 {
  unsigned k1;
  int j;
  unsigned k2;
};

__device__ __forceinline__ Top2 none() { return Top2{0u, INT_MAX, 0u}; }

__device__ __forceinline__ void push(Top2& t, float v, int c) {
  const unsigned k = value_key(v);
  if (k > t.k1 || (k == t.k1 && c < t.j)) {
    t.k2 = max(t.k2, t.k1);
    t.k1 = k;
    t.j = c;
  } else {
    t.k2 = max(t.k2, k);
  }
}

__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  if (b.k1 > a.k1 || (b.k1 == a.k1 && b.j < a.j))
    return Top2{b.k1, b.j, max(b.k2, a.k1)};
  return Top2{a.k1, a.j, max(a.k2, b.k1)};
}

// The warp's Top2 from each lane's, in three warp reductions.
__device__ __forceinline__ Top2 warp_top2(const Top2& t) {
  const unsigned k1 = __reduce_max_sync(kFull, t.k1);
  const int j = __reduce_min_sync(kFull, t.k1 == k1 ? t.j : INT_MAX);
  const unsigned k2 =
      __reduce_max_sync(kFull, t.k1 == k1 && t.j == j ? t.k2 : t.k1);
  return Top2{k1, j, k2};
}

__device__ __forceinline__ unsigned long long bid_key(float bid, int row) {
  unsigned hi;
  if (isnan(bid) || bid == INFINITY) {
    hi = kPoison;
  } else {
    const unsigned u = __float_as_uint(bid == 0.0f ? 0.0f : bid);
    hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return (static_cast<unsigned long long>(hi) << 32) |
         (0xffffffffu - static_cast<unsigned>(row));
}

__device__ __forceinline__ float key_bid(unsigned hi) {
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}

// The bid of a row whose warp-wide Top2 is t: (v1 - v2) + eps, v2
// replaced by v1 where it is not finite.
__device__ __forceinline__ unsigned long long row_key(const Top2& t,
                                                      float eps, int row) {
  const float v1 = key_value(t.k1), v2 = key_value(t.k2);
  return bid_key((v1 - (isfinite(v2) ? v2 : v1)) + eps, row);
}

// Resolve one column's key: the winner takes it. Returns 1 if the column
// was unowned before (one more row assigned), else 0.
__device__ __forceinline__ int resolve_column(unsigned long long k, int c,
                                              float* price, int* owner,
                                              int* assigned) {
  const unsigned hi = static_cast<unsigned>(k >> 32);
  if (hi <= kNegInf || hi == kPoison) return 0;
  const int row = static_cast<int>(0xffffffffu - static_cast<unsigned>(k));
  price[c] += key_bid(hi);
  const int old = owner[c];
  owner[c] = row;
  assigned[row] = 1;
  if (old >= 0) {
    assigned[old] = 0;
    return 0;
  }
  return 1;
}

// ------------------------------------------------ FastSLAM's association --

struct RowState {
  unsigned long long* key;   // [C]; the live counts of the readout after
  float* price;              // [C]
  int* owner;                // [C]
  int* assigned;             // [M]
  int* col;                  // [M] the readout
  unsigned* k1;              // [M] round 1: the best live key,
  int* j;                    //     its column,
  unsigned* k2;              //     the second-best live key,
  int* nl_j;                 //     the first column that is not live
  int* nl_n;                 //     and how many are not live
  float* part;               // [2 kWarps] per-warp hi, lo
};

__host__ __device__ constexpr size_t row_state_bytes(int M, int C) {
  return align16(16 * static_cast<size_t>(C)) +
         align16(28 * static_cast<size_t>(M)) + 8 * kWarps;
}

__device__ __forceinline__ RowState carve_rows(unsigned char* base, int M,
                                               int C) {
  RowState s;
  const size_t c = static_cast<size_t>(C), m = static_cast<size_t>(M);
  s.key = reinterpret_cast<unsigned long long*>(base);
  s.price = reinterpret_cast<float*>(base + 8 * c);
  s.owner = reinterpret_cast<int*>(base + 12 * c);
  unsigned char* r = base + align16(16 * c);
  s.assigned = reinterpret_cast<int*>(r);
  s.col = reinterpret_cast<int*>(r + 4 * m);
  s.k1 = reinterpret_cast<unsigned*>(r + 8 * m);
  s.j = reinterpret_cast<int*>(r + 12 * m);
  s.k2 = reinterpret_cast<unsigned*>(r + 16 * m);
  s.nl_j = reinterpret_cast<int*>(r + 20 * m);
  s.nl_n = reinterpret_cast<int*>(r + 24 * m);
  s.part = reinterpret_cast<float*>(r + align16(28 * m));
  return s;
}

// Apply fn(value, column) to a row's F raw values, lane-strided: 16-byte
// loads, kLoads of them issued before any is used (vec: F % 4 == 0 and the
// benefit 16-byte aligned), else one float at a time.
template <typename Fn>
__device__ __forceinline__ void for_row(const float* __restrict__ row, int F,
                                        bool vec, int lane, Fn fn) {
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const int nq = F >> 2;
    for (int q0 = lane; q0 < nq; q0 += 32 * kLoads) {
      float4 x[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (q0 + 32 * u < nq) x[u] = __ldg(r4 + q0 + 32 * u);
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int c = 4 * (q0 + 32 * u);
        if (c < F) {
          fn(x[u].x, c);
          fn(x[u].y, c + 1);
          fn(x[u].z, c + 2);
          fn(x[u].w, c + 3);
        }
      }
    }
  } else {
    for (int c = lane; c < F; c += 32) fn(__ldg(row + c), c);
  }
}

// kStateShared: the state in shared memory (else in scratch,
// row_state_bytes(M, C) per CTA).
template <bool kStateShared>
__global__ void __launch_bounds__(kThreads, 4)
    assign_kernel(const float* __restrict__ benefit, int* __restrict__ col_out,
                  int* __restrict__ iters, int P, int M, int F, float pv,
                  int budget, bool vec, unsigned char* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_left;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = F + M;
  const RowState s = carve_rows(
      kStateShared ? smem : scratch + blockIdx.x * row_state_bytes(M, C), M,
      C);
  const bool pv_live = pv > kLiveAbove;
  const size_t MF = static_cast<size_t>(M) * F;

  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const float* ben = benefit + static_cast<size_t>(p) * MF;
    for (int c = tid; c < C; c += kThreads) {
      s.key[c] = 0ull;
      s.price[c] = 0.0f;
      s.owner[c] = -1;
    }
    for (int m = tid; m < M; m += kThreads) {
      s.assigned[m] = 0;
      s.col[m] = C;
    }
    if (tid == 0) n_left = M;

    // the prologue: one pass over the rows for the clamp and round 1
    float hi = -INFINITY, lo = INFINITY;
    for (int m = warp; m < M; m += kWarps) {
      Top2 t = none();
      int nl_n = 0, nl_j = INT_MAX;
      for_row(ben + static_cast<size_t>(m) * F, F, vec, lane,
              [&](float x, int c) {
                if (x > kLiveAbove) {
                  push(t, x, c);
                  hi = fmaxf(hi, x);
                  lo = fminf(lo, x);
                } else {
                  ++nl_n;
                  nl_j = min(nl_j, c);
                }
              });
      if (lane == 0 && pv_live) {
        push(t, pv, F + m);
        hi = fmaxf(hi, pv);
        lo = fminf(lo, pv);
      }
      t = warp_top2(t);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        nl_n += __shfl_xor_sync(kFull, nl_n, off);
        nl_j = min(nl_j, __shfl_xor_sync(kFull, nl_j, off));
      }
      if (lane == 0) {
        // the private columns that are not live for row m: F + r, r != m,
        // and F + m itself where pv is not live
        const int q = M - 1 + (pv_live ? 0 : 1);
        const int q_first = (m > 0 || !pv_live) ? F : F + 1;
        s.k1[m] = t.k1;
        s.j[m] = t.j;
        s.k2[m] = t.k2;
        s.nl_j[m] = nl_n > 0 ? nl_j : (q > 0 ? q_first : INT_MAX);
        s.nl_n[m] = nl_n + q;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, off));
      lo = fminf(lo, __shfl_xor_sync(kFull, lo, off));
    }
    if (lane == 0) {
      s.part[warp] = hi;
      s.part[kWarps + warp] = lo;
    }
    __syncthreads();
    // every thread reduces the partials itself, in the same order
    hi = s.part[0];
    lo = s.part[kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      hi = fmaxf(hi, s.part[w]);
      lo = fminf(lo, s.part[kWarps + w]);
    }
    hi = isfinite(hi) ? hi : 0.0f;      // degenerate: nothing live
    lo = isfinite(lo) ? lo : 0.0f;
    const float d = __fsub_rn(hi, lo);
    const float span = d < 1.0f ? 1.0f : d;
    const float floor_v =
        __fsub_rn(__fsub_rn(lo, __fmul_rn(4.0f, span)), 1.0f);
    const float eps = __fmul_rn(kEpsFinal, span);
    const float pvc = pv_live ? pv : floor_v;

    int it = 0;
    if (budget > 0 && M > 0) {
      // round 1, from the prologue's row statistics: prices are 0, every
      // row bids; the entries that are not live all hold floor
      const unsigned kf = value_key(floor_v);
      for (int m = tid; m < M; m += kThreads) {
        Top2 t{s.k1[m], s.j[m], s.k2[m]};
        const int n_nl = s.nl_n[m];
        if (n_nl > 0) t = merge(t, Top2{kf, s.nl_j[m], n_nl > 1 ? kf : 0u});
        atomicMax(&s.key[t.j], row_key(t, eps, m));
      }
      __syncthreads();
      for (int c = tid; c < C; c += kThreads) {
        const unsigned long long k = s.key[c];
        if (k == 0ull) continue;
        s.key[c] = 0ull;
        if (resolve_column(k, c, s.price, s.owner, s.assigned))
          atomicSub(&n_left, 1);
      }
      __syncthreads();
      it = 1;
    }

    // the later rounds: the outbid rows read their rows again, clamped
    while (n_left > 0 && it < budget) {
      for (int m = warp; m < M; m += kWarps) {
        if (s.assigned[m]) continue;
        Top2 t = none();
        for_row(ben + static_cast<size_t>(m) * F, F, vec, lane,
                [&](float x, int c) {
                  push(t, (x > kLiveAbove ? x : floor_v) - s.price[c], c);
                });
        for (int r = lane; r < M; r += 32)
          push(t, (r == m ? pvc : floor_v) - s.price[F + r], F + r);
        t = warp_top2(t);
        if (lane == 0) atomicMax(&s.key[t.j], row_key(t, eps, m));
      }
      __syncthreads();
      for (int c = tid; c < C; c += kThreads) {
        const unsigned long long k = s.key[c];
        if (k == 0ull) continue;
        s.key[c] = 0ull;
        if (resolve_column(k, c, s.price, s.owner, s.assigned))
          atomicSub(&n_left, 1);
      }
      __syncthreads();
      ++it;
    }

    // the readout: the lowest column a row owns
    for (int c = tid; c < C; c += kThreads) {
      const int o = s.owner[c];
      if (o >= 0) atomicMin(&s.col[o], c);
    }
    if (n_left > 0) {
      // rows left at the budget: the best column only the row can win.
      // The keys are all 0 after the rounds; they hold the live rows per
      // feature column now.
      int* live_n = reinterpret_cast<int*>(s.key);
      for (int f = tid; f < F; f += kThreads) {
        int n = 0;
        for (int m = 0; m < M; ++m)
          n += __ldg(ben + static_cast<size_t>(m) * F + f) > kLiveAbove;
        live_n[f] = n;
      }
      __syncthreads();
      for (int m = warp; m < M; m += kWarps) {
        if (s.col[m] < C) continue;
        float bv = -INFINITY;
        int bj = INT_MAX;
        const float* row = ben + static_cast<size_t>(m) * F;
        for (int f = lane; f < F; f += 32) {
          const float x = __ldg(row + f);
          if (x > kLiveAbove && live_n[f] == 1 &&
              (x > bv || (x == bv && f < bj))) {
            bv = x;
            bj = f;
          }
        }
        if (lane == 0 && pv_live && (pv > bv || (pv == bv && F + m < bj))) {
          bv = pv;                      // column F + m: live for m alone
          bj = F + m;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(kFull, bv, off);
          const int oj = __shfl_xor_sync(kFull, bj, off);
          if (ov > bv || (ov == bv && oj < bj)) {
            bv = ov;
            bj = oj;
          }
        }
        if (lane == 0) s.col[m] = bj == INT_MAX ? 0 : bj;
      }
    }
    __syncthreads();
    for (int m = tid; m < M; m += kThreads)
      col_out[static_cast<size_t>(p) * M + m] = s.col[m];
    if (tid == 0 && iters != nullptr) iters[p] = it;
    __syncthreads();                // the state is the next particle's
  }
}

// ------------------------------------------------- the square auction --

struct SquareState {
  unsigned long long* key;   // [n]
  float* price;              // [n]
  int* owner;                // [n]
  int* assigned;             // [n]
  int* list;                 // [2 n] the columns bid on, by round parity
};

__host__ __device__ constexpr size_t square_state_bytes(int n) {
  return align16(28 * static_cast<size_t>(n));
}

__device__ __forceinline__ SquareState carve_square(unsigned char* base,
                                                    int n) {
  SquareState s;
  const size_t c = static_cast<size_t>(n);
  s.key = reinterpret_cast<unsigned long long*>(base);
  s.price = reinterpret_cast<float*>(base + 8 * c);
  s.owner = reinterpret_cast<int*>(base + 12 * c);
  s.assigned = reinterpret_cast<int*>(base + 16 * c);
  s.list = reinterpret_cast<int*>(base + 20 * c);
  return s;
}

// Lane 0 places a row's key; the first bid on a column lists it.
__device__ __forceinline__ void place_bid(const SquareState& s, int* count,
                                          int par, int n, int j,
                                          unsigned long long k) {
  if (atomicMax(&s.key[j], k) == 0ull)
    s.list[par * n + atomicAdd(&count[par], 1)] = j;
}

// A row's Top2 from v, a lane's values -cost - price at columns lane + 32
// i (n <= 32 kRegCols), all computed before any is pushed.
__device__ __forceinline__ Top2 fixed_top2(const float (&v)[kRegCols], int n,
                                           int lane) {
  Top2 t = none();
#pragma unroll
  for (int i = 0; i < kRegCols; ++i)
    if (lane + 32 * i < n) push(t, v[i], lane + 32 * i);
  return warp_top2(t);
}

// kMode: 0 the cost in device memory, the state in scratch; 1 the cost in
// device memory, the state in shared memory; 2 the cost in shared memory;
// 3 the rows below smem_rows in shared memory, the last kRegSlots row
// slots of each warp in registers (n <= 32 kRegCols, 32 warps).
template <int kMode>
__global__ void __launch_bounds__(kSquareWarps * 32, 1)
    square_kernel(const float* __restrict__ cost,
                  const float* __restrict__ eps, int* __restrict__ owner_out,
                  int* __restrict__ iters, int B, int n, int n_phases,
                  int budget, int smem_rows, unsigned char* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_left;
  __shared__ int count[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5, nt = blockDim.x;
  const SquareState s = carve_square(
      kMode == 0 ? scratch + blockIdx.x * square_state_bytes(n) : smem, n);
  float* cost_s = reinterpret_cast<float*>(smem + square_state_bytes(n));
  const size_t nn = static_cast<size_t>(n) * n;
  const bool fixed = n <= 32 * kRegCols;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const float* cost_g = cost + static_cast<size_t>(b) * nn;
    for (int c = tid; c < n; c += nt) {
      s.key[c] = 0ull;
      s.price[c] = 0.0f;
    }
    if (tid == 0) count[0] = count[1] = 0;
    if (kMode >= 2) {
      const size_t staged =
          kMode == 2 ? nn : static_cast<size_t>(smem_rows) * n;
      for (size_t i = tid; i < staged; i += nt) cost_s[i] = __ldg(cost_g + i);
    }
    float reg[kRegSlots][kRegCols];
    if (kMode == 3) {
#pragma unroll
      for (int r = 0; r < kRegSlots; ++r) {
        const int m = smem_rows + warp + r * nw;
#pragma unroll
        for (int i = 0; i < kRegCols; ++i) {
          const int c = lane + 32 * i;
          reg[r][i] = m < n && c < n
                          ? __ldg(cost_g + static_cast<size_t>(m) * n + c)
                          : 0.0f;
        }
      }
    }
    const float* rows = kMode >= 2 ? cost_s : cost_g;

    int g = 0;                      // rounds run on this problem
    for (int k = 0; k < n_phases; ++k) {
      // prices carry over; ownership starts anew
      for (int c = tid; c < n; c += nt) {
        s.owner[c] = -1;
        s.assigned[c] = 0;
      }
      if (tid == 0) n_left = n;
      const float e = eps[k];
      __syncthreads();
      int it = 0;
      while (n_left > 0 && it < budget) {
        const int par = g & 1;
        // the bids: warp w scans its unassigned rows w, w + nw, ...
        const int row_end = kMode == 3 ? smem_rows : n;
        for (int m = warp; m < row_end; m += nw) {
          if (s.assigned[m]) continue;
          const float* row = rows + static_cast<size_t>(m) * n;
          Top2 t;
          if (fixed) {
            float v[kRegCols];
#pragma unroll
            for (int i = 0; i < kRegCols; ++i) {
              const int c = lane + 32 * i;
              v[i] = c < n ? -row[c] - s.price[c] : 0.0f;
            }
            t = fixed_top2(v, n, lane);
          } else {
            t = none();
            for (int c = lane; c < n; c += 32)
              push(t, -row[c] - s.price[c], c);
            t = warp_top2(t);
          }
          if (lane == 0) place_bid(s, count, par, n, t.j, row_key(t, e, m));
        }
        // the rows in registers: their own warp bids
        if (kMode == 3) {
#pragma unroll
          for (int r = 0; r < kRegSlots; ++r) {
            const int m = smem_rows + warp + r * nw;
            if (m >= n || s.assigned[m]) continue;
            float v[kRegCols];
#pragma unroll
            for (int i = 0; i < kRegCols; ++i) {
              const int c = lane + 32 * i;
              v[i] = c < n ? -reg[r][i] - s.price[c] : 0.0f;
            }
            const Top2 t = fixed_top2(v, n, lane);
            if (lane == 0) place_bid(s, count, par, n, t.j, row_key(t, e, m));
          }
        }
        __syncthreads();
        // the resolution of the columns bid on
        const int nb = count[par];
        if (tid == 0) count[par ^ 1] = 0;   // last read before this round
        for (int t = tid; t < nb; t += nt) {
          const int c = s.list[par * n + t];
          const unsigned long long key = s.key[c];
          s.key[c] = 0ull;
          if (resolve_column(key, c, s.price, s.owner, s.assigned))
            atomicSub(&n_left, 1);
        }
        __syncthreads();
        ++it;
        ++g;
      }
      if (tid == 0 && iters != nullptr)
        iters[static_cast<size_t>(b) * n_phases + k] = it;
      __syncthreads();              // every thread has left the rounds
    }

    // the clean-up: the k-th unassigned row takes the k-th unowned column
    if (tid == 0) {
      int r = 0;
      for (int c = 0; c < n; ++c) {
        if (s.owner[c] >= 0) continue;
        while (r < n && s.assigned[r]) ++r;
        if (r < n) s.owner[c] = r++;
      }
    }
    __syncthreads();
    for (int c = tid; c < n; c += nt)
      owner_out[static_cast<size_t>(b) * n + c] = s.owner[c];
    __syncthreads();                // the state is the next problem's
  }
}

// ------------------------------------------------------------- host --

using AssignKernel = void (*)(const float*, int*, int*, int, int, int, float,
                              int, bool, unsigned char*);
using SquareKernel = void (*)(const float*, const float*, int*, int*, int,
                              int, int, int, int, unsigned char*);

// path 1: the state in shared memory; 0: in scratch
const AssignKernel kAssign[2] = {assign_kernel<false>, assign_kernel<true>};
const SquareKernel kSquare[4] = {square_kernel<0>, square_kernel<1>,
                                 square_kernel<2>, square_kernel<3>};
std::atomic<unsigned> g_assign_carved[2];
std::atomic<unsigned> g_square_carved[4];

int assign_path_for(int M, int C) {
  return phd_merge::fits_shared(kAssign[1], row_state_bytes(M, C)) ? 1 : 0;
}

int square_warps(int n) { return n < kSquareWarps ? (n > 0 ? n : 1)
                                                  : kSquareWarps; }

// the rows a square launch at n keeps in shared memory (path 3: all but
// the last kRegSlots slots of 32 warps)
int square_smem_rows(int path, int n) {
  if (path == 2) return n;
  if (path == 3) {
    const int slots = (n + kSquareWarps - 1) / kSquareWarps;
    return (slots - kRegSlots) * kSquareWarps;
  }
  return 0;
}

size_t square_smem_bytes(int path, int n) {
  if (path == 0) return 0;
  return square_state_bytes(n) +
         4 * static_cast<size_t>(square_smem_rows(path, n)) * n;
}

int square_path_for(int n) {
  if (n <= 0) return 2;
  if (phd_merge::fits_shared(kSquare[2], square_smem_bytes(2, n))) return 2;
  if (n > kSquareWarps * kRegSlots && n <= 32 * kRegCols &&
      phd_merge::fits_shared(kSquare[3], square_smem_bytes(3, n)))
    return 3;
  if (phd_merge::fits_shared(kSquare[1], square_smem_bytes(1, n))) return 1;
  return 0;
}

int occupancy(const void* kernel, int threads, size_t smem,
              std::atomic<unsigned>& carved, bool shared, int* regs) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  if (regs != nullptr) *regs = attr.numRegs;
  if (shared) return phd_merge::ctas_per_sm(kernel, threads, smem, carved);
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, 0) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

}  // namespace

extern "C" {

// Where a FastSLAM launch at M rows and C = F + M columns keeps its state:
// 1 in shared memory, 0 in device-memory scratch.
int phd_auction_path(int M, int C) { return assign_path_for(M, C); }

// Floats of device-memory scratch a FastSLAM launch of P particles takes:
// 0 unless the state does not fit a CTA's shared memory.
long long phd_auction_wide_floats(int P, int M, int F) {
  const int C = F + M;
  if (P <= 0 || M <= 0 || assign_path_for(M, C) != 0) return 0;
  const long long ctas = P < kWideCtas ? P : kWideCtas;
  return ctas * static_cast<long long>(row_state_bytes(M, C) / 4);
}

// benefit [P, M, F] float32 (gated-out pairs at _NEG), col [P, M] and
// iters [P] int32 (iters may be null); pv: the private columns' value as
// float32; budget: the most rounds a particle runs; scratch:
// phd_auction_wide_floats(P, M, F) floats of device memory (null when
// that is 0). Returns the launch's cudaError_t.
int phd_auction_launch(const float* benefit, int* col, int* iters, int P,
                       int M, int F, float pv, int budget, float* scratch,
                       void* stream) {
  if (P <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = F + M;
  const int path = assign_path_for(M, C);
  if (path == 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = path == 1 ? row_state_bytes(M, C) : 0;
  if (path == 1) {
    const cudaError_t e =
        phd_merge::allow_smem_max(kAssign[1], smem, g_assign_carved[1]);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool vec = F % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(benefit) % 16 == 0;
  const int grid = path == 0 && P > kWideCtas ? kWideCtas : P;
  kAssign[path]<<<grid, kThreads, smem, st>>>(
      benefit, col, iters, P, M, F, pv, budget, vec,
      reinterpret_cast<unsigned char*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the FastSLAM kernel a launch at M rows and C columns runs that
// fit on one SM, and its registers per thread in *regs; 0 on a refused
// query.
int phd_auction_ctas_per_sm(int M, int C, int* regs) {
  const int path = assign_path_for(M, C);
  return occupancy(reinterpret_cast<const void*>(kAssign[path]), kThreads,
                   path == 1 ? row_state_bytes(M, C) : 0,
                   g_assign_carved[path], path == 1, regs);
}

// Where a square launch at n keeps the cost and the state: 3 the cost in
// shared memory and registers, 2 in shared memory, 1 in device memory
// (the state in shared memory), 0 both in device memory.
int phd_auction_square_path(int n) { return square_path_for(n); }

// CTAs of the square kernel a launch at n runs that fit on one SM, and
// its registers per thread in *regs; 0 on a refused query.
int phd_auction_square_ctas_per_sm(int n, int* regs) {
  const int path = square_path_for(n);
  return occupancy(reinterpret_cast<const void*>(kSquare[path]),
                   32 * square_warps(n), square_smem_bytes(path, n),
                   g_square_carved[path], path > 0, regs);
}

// Floats of device-memory scratch a square launch of B problems takes: 0
// unless the state does not fit a CTA's shared memory.
long long phd_auction_square_wide_floats(int B, int n) {
  if (B <= 0 || n <= 0 || square_path_for(n) != 0) return 0;
  const long long ctas = B < kWideCtas ? B : kWideCtas;
  return ctas * static_cast<long long>(square_state_bytes(n) / 4);
}

// cost [B, n, n] and eps [n_phases] float32, owner [B, n] and iters [B,
// n_phases] int32 (iters may be null); budget: the most rounds a phase
// runs; scratch: phd_auction_square_wide_floats(B, n) floats of device
// memory (null when that is 0). Returns the launch's cudaError_t.
int phd_auction_square_launch(const float* cost, const float* eps, int* owner,
                              int* iters, int B, int n, int n_phases,
                              int budget, float* scratch, void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int path = square_path_for(n);
  if (path == 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = square_smem_bytes(path, n);
  if (path > 0) {
    const cudaError_t e = phd_merge::allow_smem_max(kSquare[path], smem,
                                                    g_square_carved[path]);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = path == 0 && B > kWideCtas ? kWideCtas : B;
  kSquare[path]<<<grid, 32 * square_warps(n), smem, st>>>(
      cost, eps, owner, iters, B, n, n_phases, budget,
      square_smem_rows(path, n), reinterpret_cast<unsigned char*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

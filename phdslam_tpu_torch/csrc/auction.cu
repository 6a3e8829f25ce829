// The Jacobi forward auction of FastSLAM's joint data association, every
// particle's rounds inside one launch, hand-written for Hopper (sm_90a).
//
// Replaces the lax.while_loop of phdslam_tpu/filter/fastslam.py ::
// _auction_rows (not a Pallas kernel: XLA runs it as a device loop whose
// trip count depends on the data; in PyTorch such a loop could only end by
// reading a flag on the host every round). The clamp before the loop and
// the column-of-row readout after it stay plain torch ops
// (filter/fastslam.py).
//
// What it computes, per particle p, from the clamped benefit [M, C] (rows
// the measurements, columns the features and then one private no-match
// column per row), eps[p] and a budget of rounds. Prices start at 0, no
// column is owned and no row assigned. Each round:
//   1. every unassigned row m takes values = benefit[m] - price, j the
//      first column of the largest value (a NaN counts as the largest), v1
//      its value and v2 the largest value over the other columns (NaN if
//      one is NaN, -inf if there is none), v2 replaced by v1 where it is
//      not finite, and bids bid = (v1 - v2) + eps on column j;
//   2. a column whose largest bid is finite (no NaN and no +inf among its
//      bids) goes to the lowest row among its largest bids: price += bid,
//      owner = that row, and the row that owned it before is unassigned;
//   3. the rounds end when every row is assigned, or at the budget.
// Outputs: owner [P, C] (-1 for an unowned column) and the rounds run per
// particle, iters [P]. kernels/auction.py::auction_rows_plain runs the same
// rounds in PyTorch ops; there is no multiply that nvcc could contract, so
// the owners agree bit for bit.
//
// Design: one CTA per particle. The benefit is staged in shared memory
// where it fits (48 KiB at M = 64, C = 192; 144 KiB at C = 576) and read
// from device memory otherwise; price, owner, assigned and the bid keys
// live in shared memory, or in a device-memory slice per CTA when C is too
// large for that (the CTAs then stride over the particles). A warp scans
// one unassigned row: lanes stride over the columns, then five shuffle
// steps merge (v1, j, v2). Each column resolves its bids with a 64-bit
// atomicMax on a key (the bid's bits in an order-preserving unsigned form)
// << 32 | (0xffffffff - row): the largest bid wins, the lowest row among
// equal ones. A NaN or +inf bid sets the top word to 0xffffffff, which
// never wins; -0 is keyed as +0. Ownership changes only where a column is
// won, so assigned is kept up to date there (a bidder owns nothing and an
// owner does not bid, so no row is touched twice in a round). Two barriers
// a round.
//
// The bid round (bid_row) reads one benefit row and the price vector only,
// and the column resolution (resolve_bids) the keys and the state only, so
// the square eps-scaled auction of the in-loop OSPA reuses both (below,
// square_kernel).
//
// ---------------------------------------------------------------------
// The square eps-scaled auction of the in-loop OSPA, every phase and the
// clean-up inside one launch, one CTA per problem.
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
// n_phases]. kernels/auction.py::auction_square_plain runs the same phases
// in PyTorch ops; -cost - price is what JAX computes (benefit = -cost,
// then benefit - price), and nothing is multiplied, so the owners and the
// rounds agree bit for bit.
//
// Design: the FastSLAM kernel's, with the benefit negated as it is read.
// The cost is staged in shared memory up to n = 238 (4 n^2 bytes beside
// the state) and read from device memory above (n = 256, the reference's
// measurement cap, is 256 KiB); the state past ~14,500 columns goes to device-memory scratch.
// A barrier after each phase's rounds keeps a thread from resetting the
// state while another still reads the count of unassigned rows. The
// clean-up is one thread's pass over the columns (O(n), once a launch).
// Bound on this card: the rounds are latency-bound (two barriers and a
// warp scan of n columns per bidding row); the bytes (the cost read once)
// are a few microseconds at n = 256.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "merge_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kPoison = 0xffffffffu;   // key top word: NaN or +inf bid
constexpr unsigned kNegInf = 0x007fffffu;   // key top word of a -inf bid
constexpr int kWideCtas = 1024;             // grid of the device-memory path

// a (at column ia) ranks before b (at ib): a NaN before every number, the
// lower column among equal values or among NaNs
__device__ __forceinline__ bool ranks_before(float a, int ia, float b,
                                             int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (na || a == b) return ia < ib;
  return a > b;
}

// the larger, NaN if either is (jnp.max and torch.amax)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

struct Best {
  float v1;   // the largest value
  int j;      // its column
  float v2;   // the largest over the other columns
};

__device__ __forceinline__ void take(Best& b, float v, int j) {
  if (ranks_before(v, j, b.v1, b.j)) {
    b.v2 = max_nan(b.v2, b.v1);
    b.v1 = v;
    b.j = j;
  } else {
    b.v2 = max_nan(b.v2, v);
  }
}

__device__ __forceinline__ Best merge(Best a, const Best& b) {
  if (ranks_before(b.v1, b.j, a.v1, a.j)) {
    Best r = b;
    r.v2 = max_nan(b.v2, max_nan(a.v2, a.v1));
    return r;
  }
  a.v2 = max_nan(a.v2, max_nan(b.v2, b.v1));
  return a;
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

// One row's bid: warp-wide, every lane returns; lane 0 places the key.
// C >= 1, so the column j is always in [0, C), NaN values included.
// kNeg: the row holds costs, and the benefit is their negation.
template <bool kNeg>
__device__ __forceinline__ void bid_row(const float* ben_row,
                                        const float* price, int C, int row,
                                        float eps, unsigned long long* key,
                                        int lane) {
  Best b{-INFINITY, INT_MAX, -INFINITY};
  for (int c = lane; c < C; c += 32)
    take(b, (kNeg ? -ben_row[c] : ben_row[c]) - price[c], c);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Best o{__shfl_xor_sync(kFull, b.v1, off),
                 __shfl_xor_sync(kFull, b.j, off),
                 __shfl_xor_sync(kFull, b.v2, off)};
    b = merge(b, o);
  }
  if (lane == 0) {
    const float v2 = isfinite(b.v2) ? b.v2 : b.v1;
    atomicMax(&key[b.j], bid_key((b.v1 - v2) + eps, row));
  }
}

struct State {
  unsigned long long* key;   // [C]
  float* price;              // [C]
  int* owner;                // [C]
  int* assigned;             // [M]
};

__host__ __device__ constexpr size_t state_bytes(int M, int C) {
  return ((16 * static_cast<size_t>(C) + 4 * static_cast<size_t>(M) + 15) /
          16) * 16;
}

__device__ __forceinline__ State carve(unsigned char* base, int C) {
  State s;
  s.key = reinterpret_cast<unsigned long long*>(base);
  s.price = reinterpret_cast<float*>(base + 8 * static_cast<size_t>(C));
  s.owner = reinterpret_cast<int*>(base + 12 * static_cast<size_t>(C));
  s.assigned = reinterpret_cast<int*>(base + 16 * static_cast<size_t>(C));
  return s;
}

// Step 2 of a round, once every bid is keyed: each column with a winning
// bid takes it. Resets the keys it reads; n_left counts unassigned rows.
__device__ __forceinline__ void resolve_bids(const State& s, int C,
                                             int* n_left, int tid) {
  for (int c = tid; c < C; c += kThreads) {
    const unsigned long long k = s.key[c];
    if (k == 0ull) continue;
    s.key[c] = 0ull;
    const unsigned hi = static_cast<unsigned>(k >> 32);
    if (hi <= kNegInf || hi == kPoison) continue;
    const int row = static_cast<int>(0xffffffffu - static_cast<unsigned>(k));
    s.price[c] += key_bid(hi);
    const int old = s.owner[c];
    if (old >= 0)
      s.assigned[old] = 0;
    else
      atomicSub(n_left, 1);
    s.owner[c] = row;
    s.assigned[row] = 1;
  }
}

// kBenShared: the benefit staged in shared memory; kStateShared: the state
// in shared memory (else in scratch, state_bytes(M, C) per CTA).
template <bool kBenShared, bool kStateShared>
__global__ void __launch_bounds__(kThreads)
    auction_kernel(const float* __restrict__ benefit,
                   const float* __restrict__ eps, int* __restrict__ owner_out,
                   int* __restrict__ iters, int P, int M, int C, int budget,
                   unsigned char* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_left;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const State s = carve(
      kStateShared ? smem : scratch + blockIdx.x * state_bytes(M, C), C);
  float* ben_s = reinterpret_cast<float*>(smem + state_bytes(M, C));
  const size_t MC = static_cast<size_t>(M) * C;

  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const float* ben_g = benefit + static_cast<size_t>(p) * MC;
    const float* ben = kBenShared ? ben_s : ben_g;
    for (int c = tid; c < C; c += kThreads) {
      s.key[c] = 0ull;
      s.price[c] = 0.0f;
      s.owner[c] = -1;
    }
    for (int m = tid; m < M; m += kThreads) s.assigned[m] = 0;
    if (kBenShared)
      for (size_t i = tid; i < MC; i += kThreads) ben_s[i] = ben_g[i];
    if (tid == 0) n_left = M;
    const float e = eps[p];
    __syncthreads();

    int it = 0;
    while (n_left > 0 && it < budget) {
      for (int m = warp; m < M; m += kWarps)
        if (!s.assigned[m])
          bid_row<false>(ben + static_cast<size_t>(m) * C, s.price, C, m, e,
                         s.key, lane);
      __syncthreads();
      resolve_bids(s, C, &n_left, tid);
      __syncthreads();
      ++it;
    }

    for (int c = tid; c < C; c += kThreads)
      owner_out[static_cast<size_t>(p) * C + c] = s.owner[c];
    if (tid == 0 && iters != nullptr) iters[p] = it;
    __syncthreads();                // the state is the next particle's
  }
}

// The square eps-scaled auction (see the head of the file): problem b's
// cost [n, n] at cost + b n^2, eps [n_phases], owner [B, n], iters [B,
// n_phases] (may be null). kCostShared: the cost staged in shared memory;
// kStateShared: the state in shared memory (else in scratch).
template <bool kCostShared, bool kStateShared>
__global__ void __launch_bounds__(kThreads)
    square_kernel(const float* __restrict__ cost,
                  const float* __restrict__ eps, int* __restrict__ owner_out,
                  int* __restrict__ iters, int B, int n, int n_phases,
                  int budget, unsigned char* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_left;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const State s = carve(
      kStateShared ? smem : scratch + blockIdx.x * state_bytes(n, n), n);
  float* cost_s = reinterpret_cast<float*>(smem + state_bytes(n, n));
  const size_t nn = static_cast<size_t>(n) * n;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const float* cost_g = cost + static_cast<size_t>(b) * nn;
    const float* cst = kCostShared ? cost_s : cost_g;
    for (int c = tid; c < n; c += kThreads) {
      s.key[c] = 0ull;
      s.price[c] = 0.0f;
    }
    if (kCostShared)
      for (size_t i = tid; i < nn; i += kThreads) cost_s[i] = cost_g[i];

    for (int k = 0; k < n_phases; ++k) {
      // prices carry over; ownership starts anew
      for (int c = tid; c < n; c += kThreads) {
        s.owner[c] = -1;
        s.assigned[c] = 0;
      }
      if (tid == 0) n_left = n;
      const float e = eps[k];
      __syncthreads();
      int it = 0;
      while (n_left > 0 && it < budget) {
        for (int m = warp; m < n; m += kWarps)
          if (!s.assigned[m])
            bid_row<true>(cst + static_cast<size_t>(m) * n, s.price, n, m, e,
                          s.key, lane);
        __syncthreads();
        resolve_bids(s, n, &n_left, tid);
        __syncthreads();
        ++it;
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
    for (int c = tid; c < n; c += kThreads)
      owner_out[static_cast<size_t>(b) * n + c] = s.owner[c];
    __syncthreads();                // the state is the next problem's
  }
}

using Kernel = void (*)(const float*, const float*, int*, int*, int, int,
                        int, int, unsigned char*);

// Where a launch keeps its data: 2 the benefit (cost) and the state in
// shared memory, 1 the state only, 0 neither (the state in scratch).
const Kernel kKernels[3] = {auction_kernel<false, false>,
                            auction_kernel<false, true>,
                            auction_kernel<true, true>};
const Kernel kSquareKernels[3] = {square_kernel<false, false>,
                                  square_kernel<false, true>,
                                  square_kernel<true, true>};

// per path, the devices where the kernel's carveout is set (paths 1 and 2:
// path 0 keeps the default carveout, its L1 caching the benefit rows)
std::atomic<unsigned> g_carved[3];
std::atomic<unsigned> g_square_carved[3];

size_t smem_bytes(int path, int M, int C) {
  if (path == 0) return 0;
  return state_bytes(M, C) +
         (path == 2 ? 4 * static_cast<size_t>(M) * C : 0);
}

int path_among(const Kernel* kernels, int M, int C) {
  if (M <= 0) return 1;
  for (int path = 2; path > 0; --path)
    if (phd_merge::fits_shared(kernels[path], smem_bytes(path, M, C)))
      return path;
  return 0;
}

int path_for(int M, int C) { return path_among(kKernels, M, C); }

int square_path_for(int n) { return path_among(kSquareKernels, n, n); }

}  // namespace

extern "C" {

// Where a launch at M rows and C columns keeps the benefit and the state:
// 2 both in shared memory, 1 the state only (the benefit read from device
// memory), 0 neither (the state in device-memory scratch).
int phd_auction_path(int M, int C) { return path_for(M, C); }

// Floats of device-memory scratch a launch of P particles takes: 0 unless
// the state does not fit a CTA's shared memory.
long long phd_auction_wide_floats(int P, int M, int C) {
  if (P <= 0 || C <= 0 || path_for(M, C) != 0) return 0;
  const long long ctas = P < kWideCtas ? P : kWideCtas;
  return ctas * static_cast<long long>(state_bytes(M, C) / 4);
}

// benefit [P, M, C] and eps [P] float32, owner [P, C] and iters [P] int32
// (iters may be null); budget: the most rounds a particle runs; scratch:
// phd_auction_wide_floats(P, M, C) floats of device memory (null when that
// is 0). Returns the launch's cudaError_t.
int phd_auction_launch(const float* benefit, const float* eps, int* owner,
                       int* iters, int P, int M, int C, int budget,
                       float* scratch, void* stream) {
  if (P <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int path = path_for(M, C);
  if (path == 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(path, M, C);
  if (path > 0) {
    const cudaError_t e =
        phd_merge::allow_smem_max(kKernels[path], smem, g_carved[path]);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = path == 0 && P > kWideCtas ? kWideCtas : P;
  kKernels[path]<<<grid, kThreads, smem, st>>>(
      benefit, eps, owner, iters, P, M, C, budget,
      reinterpret_cast<unsigned char*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the kernel a launch at M rows and C columns runs that fit on one
// SM, and its registers per thread in *regs; 0 on a refused query.
int phd_auction_ctas_per_sm(int M, int C, int* regs) {
  const int path = path_for(M, C);
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kKernels[path]) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  if (regs != nullptr) *regs = attr.numRegs;
  if (path > 0)
    return phd_merge::ctas_per_sm(kKernels[path], kThreads,
                                  smem_bytes(path, M, C), g_carved[path]);
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kKernels[0], kThreads,
                                                    0) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// Where a square launch at n keeps the cost and the state (as
// phd_auction_path).
int phd_auction_square_path(int n) { return square_path_for(n); }

// Floats of device-memory scratch a square launch of B problems takes: 0
// unless the state does not fit a CTA's shared memory.
long long phd_auction_square_wide_floats(int B, int n) {
  if (B <= 0 || n <= 0 || square_path_for(n) != 0) return 0;
  const long long ctas = B < kWideCtas ? B : kWideCtas;
  return ctas * static_cast<long long>(state_bytes(n, n) / 4);
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
  const size_t smem = smem_bytes(path, n, n);
  if (path > 0) {
    const cudaError_t e = phd_merge::allow_smem_max(kSquareKernels[path],
                                                    smem,
                                                    g_square_carved[path]);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = path == 0 && B > kWideCtas ? kWideCtas : B;
  kSquareKernels[path]<<<grid, kThreads, smem, st>>>(
      cost, eps, owner, iters, B, n, n_phases, budget,
      reinterpret_cast<unsigned char*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// What the greedy merges merge.cu (2-D), merge3.cu (3-D) and merge4.cu
// (4-D) share: the three TPU kernels run the same pick loop and differ only
// in the neighbour test and the number of moment sums. All three run the
// presorted design below (presort, stage, pick_loop, moments), each with
// its own Test and Acc, and allow_smem_max / ctas_per_sm on the host.
// merge.cu alone takes the chain otherwise, on pools that leave room for
// its tables: its gated chain (merge.cu's header) gives pick_loop's picks
// and owners in batches of up to 32 with a reach gate before each exact
// test. merge.cu's wider pools, merge3.cu and merge4.cu run pick_loop.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace phd_merge {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------------
// The presorted design.
//
// The pick chain is fixed by the input weights: absorbing a candidate only
// zeroes its weight, and every other weight stays as it was. So the greedy
// picks are the live candidates (w > 0; w <= 0 and NaN never are) in the
// order (w descending, index ascending), skipping those already absorbed.
// One block-wide sort at the start gives that order; every sorted position
// before the current pick is merged already.
//
// Picks go in batches of G: the next g <= G unmerged positions q_0 < ... <
// q_{g-1}. One pass tests every unmerged position p > q_0 against the batch
// picks before it, in order, and the first near one takes it: that is what
// g picks one after another would do, as long as no batch pick is itself
// near an earlier one. When q_k is (the least such k), the batch keeps its
// first k picks: q_k goes to its first near pick, the slots from k on are
// undone and their candidates freed. A candidate taken records owner =
// slot and nothing else, so a batch ends in one __syncthreads (two when it
// was cut) and no reduction. The G tests of a candidate are independent,
// so a thread keeps G chains in flight. After the loop one warp walks the
// positions once, from the last down, and threads each slot's members into
// a list in position order; then one thread per slot sums the slot's
// moments along its list: no float atomics, the same result on every run.
//
// The pool of a kernel with C float channels per candidate, with Idx the
// index type (unsigned short in shared memory, (4 C + 6) bytes per
// candidate; unsigned in the device-memory pool of a pool too wide for a
// CTA's shared memory, (4 C + 12) bytes):
//   float pool[C][K]   the live candidates in sorted order
//   Idx owner[K]       per position, the slot that absorbed it; then the
//                      next member of that slot
//   Idx pick[K]        per slot, the position of its pick
//   Idx head[K]        per slot, its first member after the pick
// The presort's 64-bit keys alias the start of pool (8 pow2(L) < 16 K <=
// 4 C K bytes) and its rank of each candidate aliases pick. Every function
// below works on either memory: shared memory while the pool fits a CTA's
// 227 KB, else one pool per CTA in device memory that the wrapper
// allocates (wide_floats), where the CTAs stride over the particles. The
// only limit on K is then device memory.

// the owner of an unmerged position, the end of a member list
template <typename Idx>
__host__ __device__ constexpr Idx free_idx() {
  return static_cast<Idx>(~0u);
}

__host__ __device__ constexpr size_t smem_bytes(int channels, int K) {
  return static_cast<size_t>(4 * channels + 6) * K;
}

constexpr int kWideCtas = 1024;     // grid of the device-memory pool path

// Floats of one CTA's device-memory pool (a multiple of 2, so that the
// next CTA's keys stay 8-byte aligned), and of the grid's for P particles.
__host__ __device__ constexpr size_t wide_pool_floats(int channels, int K) {
  return (static_cast<size_t>(4 * channels + 12) * K + 7) / 8 * 2;
}

inline int wide_ctas(int P) { return P < kWideCtas ? P : kWideCtas; }

inline long long wide_floats(int channels, int P, int K) {
  return static_cast<long long>(wide_ctas(P)) *
         static_cast<long long>(wide_pool_floats(channels, K));
}

template <typename Idx>
struct Books {
  Idx* owner;
  Idx* pick;
  Idx* head;
  __device__ Books(float* pool, int channels, int K)
      : owner(reinterpret_cast<Idx*>(pool + static_cast<size_t>(channels) *
                                                 K)),
        pick(owner + K),
        head(pick + K) {}
};

// Ascending bitonic sort of n (a power of 2) keys in shared memory.
template <int kThreads>
__device__ __forceinline__ void bitonic_sort(unsigned long long* key, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += kThreads) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const unsigned long long a = key[lo], b = key[hi];
        if ((a > b) == ((lo & k) == 0)) {
          key[lo] = b;
          key[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Sorts the live candidates of w [K] (global memory) by (w descending,
// index ascending) and leaves b.pick[j] = the sorted position of candidate
// j (kFree if it is not live) and b.owner[p] = kFree for p < L.
// The key of a live candidate is (~bits(w)) << 32 | j: the bits of a
// positive float order as unsigned integers. Returns L, the live count.
template <int kThreads, typename Idx>
__device__ __forceinline__ int presort(const float* __restrict__ w, int K,
                                       float* pool, const Books<Idx>& b) {
  constexpr Idx kFree = free_idx<Idx>();
  __shared__ int s_live;
  unsigned long long* key = reinterpret_cast<unsigned long long*>(pool);
  const int t = threadIdx.x;
  const int lane = t & 31;
  if (t == 0) s_live = 0;
  __syncthreads();
  for (int j0 = 0; j0 < K; j0 += kThreads) {
    const int j = j0 + t;
    const float wj = j < K ? w[j] : 0.0f;
    const bool live = wj > 0.0f;
    if (j < K) b.pick[j] = kFree;
    const unsigned m = __ballot_sync(kFull, live);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&s_live, __popc(m));
    base = __shfl_sync(kFull, base, 0);
    if (live)
      key[base + __popc(m & ((1u << lane) - 1u))] =
          (static_cast<unsigned long long>(~__float_as_uint(wj)) << 32) |
          static_cast<unsigned>(j);
  }
  __syncthreads();
  const int L = s_live;
  int n = 1;
  while (n < L) n <<= 1;
  for (int p = L + t; p < n; p += kThreads) key[p] = ~0ull;
  __syncthreads();
  bitonic_sort<kThreads>(key, n);
  for (int p = t; p < L; p += kThreads) {
    b.pick[static_cast<unsigned>(key[p])] = static_cast<Idx>(p);
    b.owner[p] = kFree;
  }
  __syncthreads();
  return L;
}

// Copies the C channels of every live candidate j from global memory
// (src[c][j], coalesced) to its sorted position in pool[c][.], over the
// presort's keys, and publishes them.
template <int kThreads, int C, typename Idx>
__device__ __forceinline__ void stage(const float* const (&src)[C], int K,
                                      float* pool, const Books<Idx>& b) {
  for (int j = threadIdx.x; j < K; j += kThreads) {
    const Idx r = b.pick[j];
    if (r == free_idx<Idx>()) continue;
#pragma unroll
    for (int c = 0; c < C; ++c)
      pool[static_cast<size_t>(c) * K + r] = src[c][j];
  }
  __syncthreads();
}

// The greedy pick chain over the L sorted positions, at most cap picks, in
// batches of G. The test object holds the batch's pick data in registers:
//   test.pick(j, pos)     loads pick j (j a compile-time index);
//   test.load(p)          the candidate data the cheap test reads;
//   test.maybe(j, x)      a cheap test, false only where the test is;
//   test.confirm(pos, p)  the test of position p against the pick at pos,
//                         called only where maybe held.
// Leaves b.pick[i] and b.owner filled for the n slots it returns, published
// by its last barrier.
template <int kThreads, int G, typename Test, typename Idx>
__device__ __forceinline__ int pick_loop(Test& test, int L, int cap,
                                         const Books<Idx>& b) {
  constexpr Idx kFree = free_idx<Idx>();
  static_assert(G >= 1 && G <= 32 && 3 * G <= kThreads, "batch size");
  // per batch, three buffers in turn: the least batch pick near an earlier
  // one (G: none), and each batch pick's first near earlier pick (-1: none)
  __shared__ int s_cut[3];
  __shared__ int s_qown[3][G];
  const int t = threadIdx.x;
  const int lane = t & 31;
  if (t < 3) s_cut[t] = G;
  if (t < 3 * G) s_qown[t / G][t % G] = -1;
  __syncthreads();
  int n = 0, from = 0;
  for (int batch = 0; n < cap; ++batch) {
    const int buf = batch % 3;
    // the next g unmerged positions, alike in every warp: lane k holds q_k
    // (the pass writes no position up to q_{g-1} that is unmerged)
    const int gmax = min(G, cap - n);
    int g = 0, myq = 0;
    for (int base = from; base < L && g < gmax; base += 32) {
      const int p = base + lane;
      const unsigned m = __ballot_sync(kFull, p < L && b.owner[p] == kFree);
      const int k = lane - g;
      if (k >= 0 && lane < gmax) {
        unsigned mm = m;
        for (int i = 0; i < k && mm; ++i) mm &= mm - 1;
        if (mm) myq = base + __ffs(mm) - 1;
      }
      g = min(gmax, g + __popc(m));
    }
    if (g == 0) break;
    int q[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      q[j] = __shfl_sync(kFull, myq, min(j, g - 1));
      test.pick(j, q[j]);
    }
    const int qlast = __shfl_sync(kFull, myq, g - 1);
    const int nxt = (batch + 1) % 3;  // last read two barriers ago
    if (t == 0) s_cut[nxt] = G;
    if (t < G) s_qown[nxt][t] = -1;
    for (int p = q[0] + 1 + t; p < L; p += kThreads) {
      if (b.owner[p] != kFree) continue;
      const auto x = test.load(p);
      unsigned near = 0;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const bool mb = test.maybe(j, x);
        if (j < g && q[j] < p && mb) near |= 1u << j;
      }
      int own = -1;
      while (near) {
        const int j = __ffs(near) - 1;
        near &= near - 1;
        int pos = q[0];
#pragma unroll
        for (int i = 1; i < G; ++i)
          if (i == j) pos = q[i];
        if (test.confirm(pos, p)) {
          own = j;
          break;
        }
      }
      if (own < 0) continue;
      if (p <= qlast) {               // a batch pick near an earlier one
        int k = 0;
#pragma unroll
        for (int i = 1; i < G; ++i)
          if (i < g && q[i] == p) k = i;
        s_qown[buf][k] = own;
        atomicMin(&s_cut[buf], k);
      } else {
        b.owner[p] = static_cast<Idx>(n + own);
      }
    }
    if (t < g) b.pick[n + t] = static_cast<Idx>(myq);
    __syncthreads();
    const int k = min(s_cut[buf], g);
    if (k < g) {                      // keep picks 0 .. k-1 only
      for (int p = qlast + 1 + t; p < L; p += kThreads) {
        const Idx o = b.owner[p];
        if (o != kFree && o >= n + k) b.owner[p] = kFree;
      }
      if (t >= k && t < g) {
        const int o = s_qown[buf][t];
        if (o >= 0 && o < k) b.owner[myq] = static_cast<Idx>(n + o);
      }
      __syncthreads();
    }
    n += k;
    from = __shfl_sync(kFull, myq, k - 1) + 1;
  }
  // The scan that ends the loop (g == 0) reads owner after the last
  // batch's barrier; link_members rewrites owner. Without this barrier a
  // warp that has left the loop relinks owner while a slower warp still
  // scans it, and that warp then sees a free position, runs a batch of its
  // own and leaves the member lists cyclic or out of range: an illegal
  // address in moments, in about one launch of a few hundred on pools
  // whose picks absorb most candidates (a long final scan).
  __syncthreads();
  return n;
}

// Threads the members of the n slots into lists in position order: head[s]
// the first member of slot s after its pick, owner[p] then the member after
// p (kFree ends a list). One warp walks the positions from the last down,
// 32 at a time; the lanes of one slot in a chunk link to each other, the
// highest to the slot's current head, and the lowest becomes the head.
template <typename Idx>
__device__ __forceinline__ void link_members(int L, int n,
                                             const Books<Idx>& b) {
  constexpr Idx kFree = free_idx<Idx>();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int s = lane; s < n; s += 32) b.head[s] = kFree;
    __syncwarp();
    for (int base = (L - 1) & ~31; base >= 0; base -= 32) {
      const int p = base + lane;
      const Idx o = p < L ? b.owner[p] : kFree;
      const unsigned grp = __match_any_sync(kFull, static_cast<unsigned>(o));
      const unsigned higher = grp & ~((2u << lane) - 1u);
      Idx next = kFree;
      if (o != kFree)
        next = higher ? static_cast<Idx>(base + __ffs(higher) - 1)
                      : b.head[o];
      __syncwarp();
      if (o != kFree) {
        b.owner[p] = next;
        if ((grp & ((1u << lane) - 1u)) == 0)
          b.head[o] = static_cast<Idx>(p);
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

// The moments of the n slots, and the empty ones up to cap, one thread per
// slot: acc.begin(pick), acc.add(j) along the slot's list, acc.store(s);
// acc.empty(s) for a slot not filled.
template <int kThreads, typename Acc, typename Idx>
__device__ __forceinline__ void moments(Acc& acc, int L, int n, int cap,
                                        const Books<Idx>& b) {
  link_members(L, n, b);
  for (int s = threadIdx.x; s < cap; s += kThreads) {
    if (s >= n) {
      acc.empty(s);
      continue;
    }
    acc.begin(b.pick[s]);
    for (Idx j = b.head[s]; j != free_idx<Idx>(); j = b.owner[j]) acc.add(j);
    acc.store(s);
  }
}

// Raises the dynamic shared-memory limit of kernel when smem needs more
// than the default 48 KB, and sets the largest shared-memory carveout, so
// that as many CTAs fit on an SM as their shared memory allows. The
// carveout is set once per device: carved, one word per kernel kept by its
// launcher, holds a bit per device where it is set (devices from 32 on set
// it at every call). A refusal is cleared from the error state (the next
// launch must not report it as its own) and returned.
template <typename Kernel>
inline cudaError_t allow_smem_max(Kernel kernel, size_t smem,
                                  std::atomic<unsigned>& carved) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (e == cudaSuccess && !(carved.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (e == cudaSuccess) carved.fetch_or(bit, std::memory_order_relaxed);
  }
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// Whether smem bytes of dynamic shared memory, beside kernel's static
// shared memory, fit the most a CTA of this device may use.
template <typename Kernel>
inline bool fits_shared(Kernel kernel, size_t smem) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return attr.sharedSizeBytes + smem <= static_cast<size_t>(optin);
}

// CTAs of kernel that fit on one SM at this block size and shared memory;
// 0 if the launch would be refused.
template <typename Kernel>
inline int ctas_per_sm(Kernel kernel, int threads, size_t smem,
                       std::atomic<unsigned>& carved) {
  if (allow_smem_max(kernel, smem, carved) != cudaSuccess) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

}  // namespace phd_merge

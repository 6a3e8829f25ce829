// The pick order and the end-of-pick block reduction shared by the greedy
// merges merge.cu (2-D), merge3.cu (3-D) and merge4.cu (4-D): the three TPU
// kernels run the same pick loop and differ only in the neighbour test and
// the number of moment sums.
//
// The reduction is a fixed shuffle tree per warp and a fixed-order sum
// across warps: no atomics, the same result on every run. The warp partials
// go to this pick's half of a double buffer, so one __syncthreads per pick
// suffices, and every thread combines them itself, so the whole block holds
// the next pick without a second barrier.

#pragma once

#include <cuda_runtime.h>

namespace phd_merge {

constexpr unsigned kFull = 0xffffffffu;

// (value desc, index asc): the candidate order of the greedy pick.
__device__ __forceinline__ void better(float& bv, int& bi, float ov, int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

// Block-wide sums of s[] and argmax of (mv, mi); every thread gets the
// result. red_f holds kWarps * (kSums + 1) floats, red_i kWarps ints.
template <int kSums, int kWarps>
__device__ __forceinline__ void block_reduce(float (&s)[kSums], float& mv,
                                             int& mi, float* red_f,
                                             int* red_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] += __shfl_xor_sync(kFull, s[k], o);
    better(mv, mi, __shfl_xor_sync(kFull, mv, o),
           __shfl_xor_sync(kFull, mi, o));
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) red_f[warp * (kSums + 1) + k] = s[k];
    red_f[warp * (kSums + 1) + kSums] = mv;
    red_i[warp] = mi;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSums; ++k) s[k] = red_f[k];
  mv = red_f[kSums];
  mi = red_i[0];
  for (int v = 1; v < kWarps; ++v) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] += red_f[v * (kSums + 1) + k];
    better(mv, mi, red_f[v * (kSums + 1) + kSums], red_i[v]);
  }
}

// Raises the dynamic shared-memory limit of kernel when smem needs more
// than the default 48 KB. A refusal is cleared from the error state (the
// next launch must not report it as its own) and returned.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

}  // namespace phd_merge

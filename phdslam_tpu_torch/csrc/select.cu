// Fused likelihood / normaliser / top-k1 selection of the GM-PHD update of
// the 2-D static map, hand-written for Hopper (sm_90a).
//
// Replaces two TPU kernels of phdslam_tpu/kernels/preupdate_pallas.py:
//   fused_update_select (Pallas bodies _kernel and _kernel_ft, the same
//     outputs in two TPU layouts): the picks with their payload;
//   fused_update_select_by_index (body _kernel_by_index): the same picks as
//     (weight, index), by_index = 1 here, for a caller that gathers the
//     payload itself.
//
// What it computes, for particle p and measurement m < n_valid, over the
// particle's F map slots f:
//   ir = z_r - r_f;  ib = wrap(z_b - b_f)      (wrap: x - 2pi*rint(x/2pi))
//   d2 = max(ir^2 si00 + 2 ir ib si01 + ib^2 si11, 0)
//   e_f = exp(lpw_f - log 2pi - lds_f / 2 - d2 / 2)
//   sum[p,m] = sum_f e_f;  compat[p,m] = any_f(in range && d2 < gate)
//   w_f = e_f / (sum + clutter + birth), pruned below min_weight (raw: e_f)
// then the k1 largest w_f (lowest f on ties) and, by_index = 0, their
// payload: the updated mean mx + K innov, the updated covariance (u00, u01,
// u11) and lpw; by_index = 1, their index f (0 where w = 0). Columns
// m >= n_valid are zeros.
//
// What bounds it on an H100: P*M*F (p, m, f) triples, each with one expf,
// about a dozen flops and k1 compare rounds. At the dense shape
// (8192 x 64 x 512) that is 2.7e8 triples of SFU/ALU work; the inputs are
// 16 [P, F] channels read once (7 in the by-index mode). The [P, M, F]
// likelihood tensor (1 GiB per float32 channel at that shape) never reaches
// device memory.
//
// Design (select_common.cuh): one CTA per particle, the seven loop channels
// staged in shared memory once, one warp per measurement with a
// lane-private slice of its row buffer, shuffle reductions for the sum and
// the gate flag, and k1 warp argmax rounds. Lane j keeps round j's winner,
// so the payload of all k1 winners is read from device memory in parallel
// at the end. expf (not __expf) keeps the kernel within ulps of the plain
// PyTorch version.

#include <cuda_runtime.h>

#include "select_common.cuh"

namespace {

using namespace phd_select;

struct Channels {
  const float *r, *b, *lpw, *si00, *si01, *si11, *lds, *mx, *my, *g00, *g01,
      *g10, *g11, *u00, *u01, *u11;
};

struct Outputs {
  float *sum, *w, *mx, *my, *u00, *u01, *u11, *lpw;
  int* idx;
  unsigned char* compat;
};

__global__ void __launch_bounds__(kWarps * 32)
    select_kernel(Channels in, const float* __restrict__ z,
                  const int* __restrict__ n_valid, Outputs out, int F, int M,
                  int k1, float clutter_birth, float min_weight, float gate,
                  int raw, int with_compat, int with_lpw, int by_index) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  const size_t off = static_cast<size_t>(p) * F;
  const Staged s = stage(smem, F, off, in.r, in.b, in.lpw, in.si00, in.si01,
                         in.si11, in.lds);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row = s.rows + warp * F;
  const int nv = min(*n_valid, M);

  for (int m = warp; m < M; m += kWarps) {
    const size_t pm = static_cast<size_t>(p) * M + m;
    const size_t sel = pm * k1;
    if (m >= nv) {
      if (lane < k1) {
        out.w[sel + lane] = 0.f;
        if (by_index) {
          out.idx[sel + lane] = 0;
        } else {
          out.mx[sel + lane] = 0.f;
          out.my[sel + lane] = 0.f;
          out.u00[sel + lane] = 0.f;
          out.u01[sel + lane] = 0.f;
          out.u11[sel + lane] = 0.f;
          out.lpw[sel + lane] = 0.f;
        }
      }
      if (lane == 0) {
        out.sum[pm] = 0.f;
        out.compat[pm] = 0;
      }
      continue;
    }
    const float zr = z[2 * m];
    const float zb = z[2 * m + 1];

    bool hit;
    const float sum =
        likelihood_row(s, row, F, lane, zr, zb, with_compat, gate, &hit);
    if (!raw) {
      const float inv = 1.0f / (sum + clutter_birth);
      for (int f = lane; f < F; f += 32) {
        const float v = row[f] * inv;
        row[f] = v >= min_weight ? v : 0.0f;
      }
    }
    float my_v;
    int my_i;
    top_k1(row, F, k1, lane, &my_v, &my_i);

    if (lane < k1) {
      const bool alive = my_v > 0.0f;
      out.w[sel + lane] = alive ? my_v : 0.0f;
      if (by_index) {
        out.idx[sel + lane] = alive ? my_i : 0;
      } else {
        const size_t g = off + my_i;
        const float ir = zr - s.r[my_i];
        const float ib = wrap_round(zb - s.b[my_i]);
        out.mx[sel + lane] = in.mx[g] + in.g00[g] * ir + in.g01[g] * ib;
        out.my[sel + lane] = in.my[g] + in.g10[g] * ir + in.g11[g] * ib;
        out.u00[sel + lane] = in.u00[g];
        out.u01[sel + lane] = in.u01[g];
        out.u11[sel + lane] = in.u11[g];
        out.lpw[sel + lane] = with_lpw ? s.lpw[my_i] : 0.0f;
      }
    }
    if (lane == 0) {
      out.sum[pm] = sum;
      out.compat[pm] = (with_compat && hit) ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

const char* phd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Channels are [P, F] row-major float32; z is [M, 2]; n_valid points to one
// int32 on the device. Outputs: sum [P, M], w [P, M, k1], compat [P, M] as
// bytes, and either the six payload channels [P, M, k1] (mx, my, u00, u01,
// u11, lpw; by_index = 0) or idx [P, M, k1] int32 (by_index = 1). The
// pointers a mode does not use may be null: by_index = 1 reads only the
// first seven channels. Returns the launch's cudaError_t.
int phd_select_launch(const float* r, const float* b, const float* lpw,
                      const float* si00, const float* si01,
                      const float* si11, const float* lds, const float* mx,
                      const float* my, const float* g00, const float* g01,
                      const float* g10, const float* g11, const float* u00,
                      const float* u01, const float* u11, const float* z,
                      const int* n_valid, float* sum_out, float* w_out,
                      float* mx_out, float* my_out, float* u00_out,
                      float* u01_out, float* u11_out, float* lpw_out,
                      int* idx_out, unsigned char* compat_out, int P, int F,
                      int M, int k1, float clutter_birth, float min_weight,
                      float gate, int raw, int with_compat, int with_lpw,
                      int by_index, void* stream) {
  if (P <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  if (F <= 0 || k1 <= 0 || k1 > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(F);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not see it
      return static_cast<int>(e);
    }
  }
  Channels in{r,   b,   lpw, si00, si01, si11, lds, mx,
              my,  g00, g01, g10,  g11,  u00,  u01, u11};
  Outputs out{sum_out, w_out,   mx_out,  my_out,  u00_out,
              u01_out, u11_out, lpw_out, idx_out, compat_out};
  select_kernel<<<P, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      in, z, n_valid, out, F, M, k1, clutter_birth, min_weight, gate, raw,
      with_compat, with_lpw, by_index);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

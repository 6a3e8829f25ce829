// Fused likelihood / normaliser / top-k1 selection of the GM-PHD update,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel phdslam_tpu/kernels/preupdate_pallas.py ::
// fused_update_select (Pallas body _kernel; _kernel_ft computes the same
// outputs in a transposed TPU layout, so this one kernel covers both).
//
// What it computes, for particle p and measurement m < n_valid, over the
// particle's F map slots f:
//   ir = z_r - r_f;  ib = wrap(z_b - b_f)      (wrap: x - 2pi*rint(x/2pi))
//   d2 = max(ir^2 si00 + 2 ir ib si01 + ib^2 si11, 0)
//   e_f = exp(lpw_f - log 2pi - lds_f / 2 - d2 / 2)
//   sum[p,m] = sum_f e_f;  compat[p,m] = any_f(in range && d2 < gate)
//   w_f = e_f / (sum + clutter + birth), pruned below min_weight (raw: e_f)
// then the k1 largest w_f (lowest f on ties) with their payload: the
// updated mean mx + K innov, the updated covariance (u00, u01, u11) and
// lpw. Columns m >= n_valid are zeros.
//
// What bounds it on an H100: P*M*F (p, m, f) triples, each with one expf,
// about a dozen flops and k1 compare rounds. At the dense shape
// (8192 x 64 x 512) that is 2.7e8 triples of SFU/ALU work; the inputs are
// 16 [P, F] channels read once. The [P, M, F] likelihood tensor (1 GiB per
// float32 channel at that shape) never reaches device memory.
//
// Design: one CTA per particle. The seven channels the inner loop reads
// (r, b, lpw - log 2pi - lds/2, si00, si01, si11, lpw) are staged in shared
// memory once. Each warp takes measurements m = warp, warp + 8, ...; its 32
// lanes stride F, so lane l owns the slots f = l (mod 32) of the warp's
// row buffer and no barrier is needed between the passes. The sum and the
// gate flag reduce with shuffles; each of the k1 rounds is a warp argmax
// with a (value desc, index asc) order, whose owner lane zeroes the winner.
// Lane j keeps round j's winner, so the payload of all k1 winners is read
// from device memory in parallel at the end. expf (not __expf) keeps the
// kernel within ulps of the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kNegLarge = -1e30f;
constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ float wrap_round(float x) {
  return x - kTwoPi * rintf(x / kTwoPi);
}

struct Channels {
  const float *r, *b, *lpw, *si00, *si01, *si11, *lds, *mx, *my, *g00, *g01,
      *g10, *g11, *u00, *u01, *u11;
};

struct Outputs {
  float *sum, *w, *mx, *my, *u00, *u01, *u11, *lpw;
  unsigned char* compat;
};

__global__ void __launch_bounds__(kWarps * 32)
    select_kernel(Channels in, const float* __restrict__ z,
                  const int* __restrict__ n_valid, Outputs out, int F, int M,
                  int k1, float clutter_birth, float min_weight, float gate,
                  int raw, int with_compat, int with_lpw) {
  extern __shared__ float smem[];
  float* s_r = smem;
  float* s_b = s_r + F;
  float* s_base = s_b + F;
  float* s_si00 = s_base + F;
  float* s_si01 = s_si00 + F;
  float* s_si11 = s_si01 + F;
  float* s_lpw = s_si11 + F;

  const int p = blockIdx.x;
  const size_t off = static_cast<size_t>(p) * F;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const float l = in.lpw[off + f];
    s_r[f] = in.r[off + f];
    s_b[f] = in.b[off + f];
    s_base[f] = l - kLog2Pi - 0.5f * in.lds[off + f];
    s_si00[f] = in.si00[off + f];
    s_si01[f] = in.si01[off + f];
    s_si11[f] = in.si11[off + f];
    s_lpw[f] = l;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row = s_lpw + F + warp * F;
  const int nv = min(*n_valid, M);

  for (int m = warp; m < M; m += kWarps) {
    const size_t pm = static_cast<size_t>(p) * M + m;
    const size_t sel = pm * k1;
    if (m >= nv) {
      if (lane < k1) {
        out.w[sel + lane] = 0.f;
        out.mx[sel + lane] = 0.f;
        out.my[sel + lane] = 0.f;
        out.u00[sel + lane] = 0.f;
        out.u01[sel + lane] = 0.f;
        out.u11[sel + lane] = 0.f;
        out.lpw[sel + lane] = 0.f;
      }
      if (lane == 0) {
        out.sum[pm] = 0.f;
        out.compat[pm] = 0;
      }
      continue;
    }
    const float zr = z[2 * m];
    const float zb = z[2 * m + 1];

    float s = 0.f;
    bool hit = false;
    for (int f = lane; f < F; f += 32) {
      const float ir = zr - s_r[f];
      const float ib = wrap_round(zb - s_b[f]);
      float d2 = ir * ir * s_si00[f] + 2.0f * ir * ib * s_si01[f] +
                 ib * ib * s_si11[f];
      d2 = fmaxf(d2, 0.0f);
      const float e = expf(s_base[f] - 0.5f * d2);
      s += e;
      hit = hit || (s_lpw[f] > 0.5f * kNegLarge && d2 < gate);
      row[f] = e;
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    hit = __any_sync(kFull, hit);

    if (!raw) {
      const float inv = 1.0f / (s + clutter_birth);
      for (int f = lane; f < F; f += 32) {
        const float v = row[f] * inv;
        row[f] = v >= min_weight ? v : 0.0f;
      }
    }

    float my_v = 0.f;
    int my_i = 0;
    for (int j = 0; j < k1; ++j) {
      float bv = -1.0f;
      int bi = F;
      for (int f = lane; f < F; f += 32) {
        const float v = row[f];
        if (v > bv) {
          bv = v;
          bi = f;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, o);
        const int oi = __shfl_xor_sync(kFull, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if ((bi & 31) == lane && bi < F) row[bi] = 0.0f;
      if (lane == j) {
        my_v = bv;
        my_i = bi;
      }
    }

    if (lane < k1) {
      const size_t g = off + my_i;
      const float ir = zr - s_r[my_i];
      const float ib = wrap_round(zb - s_b[my_i]);
      out.w[sel + lane] = my_v > 0.0f ? my_v : 0.0f;
      out.mx[sel + lane] = in.mx[g] + in.g00[g] * ir + in.g01[g] * ib;
      out.my[sel + lane] = in.my[g] + in.g10[g] * ir + in.g11[g] * ib;
      out.u00[sel + lane] = in.u00[g];
      out.u01[sel + lane] = in.u01[g];
      out.u11[sel + lane] = in.u11[g];
      out.lpw[sel + lane] = with_lpw ? s_lpw[my_i] : 0.0f;
    }
    if (lane == 0) {
      out.sum[pm] = s;
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
// int32 on the device. Outputs: sum [P, M], seven [P, M, k1] channels
// (w, mx, my, u00, u01, u11, lpw) and compat [P, M] as bytes. Returns the
// launch's cudaError_t.
int phd_select_launch(const float* r, const float* b, const float* lpw,
                      const float* si00, const float* si01,
                      const float* si11, const float* lds, const float* mx,
                      const float* my, const float* g00, const float* g01,
                      const float* g10, const float* g11, const float* u00,
                      const float* u01, const float* u11, const float* z,
                      const int* n_valid, float* sum_out, float* w_out,
                      float* mx_out, float* my_out, float* u00_out,
                      float* u01_out, float* u11_out, float* lpw_out,
                      unsigned char* compat_out, int P, int F, int M, int k1,
                      float clutter_birth, float min_weight, float gate,
                      int raw, int with_compat, int with_lpw, void* stream) {
  if (P <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  if (F <= 0 || k1 <= 0 || k1 > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(7 + kWarps) * F * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Channels in{r,   b,   lpw, si00, si01, si11, lds, mx,
              my,  g00, g01, g10,  g11,  u00,  u01, u11};
  Outputs out{sum_out, w_out,   mx_out,  my_out, u00_out,
              u01_out, u11_out, lpw_out, compat_out};
  select_kernel<<<P, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      in, z, n_valid, out, F, M, k1, clutter_birth, min_weight, gate, raw,
      with_compat, with_lpw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

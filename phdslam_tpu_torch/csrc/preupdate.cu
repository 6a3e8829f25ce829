// The Kalman pre-update of the 2-D static map in one pass, hand-written for
// Hopper (sm_90a): every measurement-independent EKF term of every
// (particle, map slot).
//
// Replaces no TPU kernel. The JAX package leaves
// phdslam_tpu/filter/update.py::kalman_preupdate to XLA, which fuses the
// chain into one loop; PyTorch runs the same chain (kernels/preupdate.py ::
// preupdate_plain) as about 170 elementwise launches over [P, F], each
// reading one or two [P, F] channels and writing one. On an H100 that chain
// was the largest stage of the static step at 65,536 x 128 (5.8 ms of a
// 15.3 ms step) and the largest block of host launches at 8192 x 512.
//
// What it computes, per element (p, f), from the six map channels w, mx,
// my, c00, c01, c11 and the particle's pose (x, y, theta): the predicted
// range r and bearing (wrapped by fmod, then folded), the range class
// (1 in range, 2 near, 0 out or an empty slot w <= 0), pd where the class
// is 1, and with the benign geometry dx = 1, dy = 0 outside it the
// Jacobian J, S = J P J^T + R with the cancellation-free determinant
// det(P) / r^2 + a00 var_b + a11 var_r + var_r var_b (floored at det R),
// S^-1, the gain K = P J^T S^-1 and the Joseph-form covariance
// (I - K J) P (I - K J)^T + K R K^T. Outputs, in this order, 14 float32
// channels of one [14, P, F] block (r, bearing, pd, g00, g01, g10, g11,
// u00, u01, u11, si00, si01, si11, log det S) and the class as int32
// [P, F].
//
// Bit for bit the plain chain's float32 results on the card. The greedy
// merge downstream is discontinuous: one ulp in a covariance can change a
// merge decision. So the kernel runs the plain chain's operations in its
// order, each multiply, add and subtract as __fmul_rn / __fadd_rn /
// __fsub_rn (nvcc's multiply-add contraction, on for every kernel of the
// library, cannot fuse two of them), each division as an IEEE division
// (__fdiv_rn; every division of the chain is tensor by tensor), and
// sqrtf, atan2f, fmodf, logf and fmaxf, the functions PyTorch's CUDA
// kernels call; its clamps pass NaN through as torch.clamp does. Python
// scalars enter as the float32 of Python's double, as PyTorch casts a
// scalar operand: the wrapper computes them as the chain does and ctypes
// rounds each to float.
//
// What bounds it on an H100: bytes. Six channels in and fifteen out, 84
// bytes an element (the pose rows come from cache); about 200 float32
// operations an element, 2.4 a byte, far below the ~20 a byte at which the
// card's arithmetic would bind. The design streams: a grid-stride loop
// whose threads each take four consecutive elements of one particle with
// 16-byte loads and stores where F % 4 == 0 and every pointer is 16-byte
// aligned, else one element at a time; no shared memory, no atomics, no
// tunable. Every run gives the same result.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kOut = 14;               // float output channels

// Python's scalars, each the float32 of the double the plain chain uses.
struct Scalars {
  float var_r, var_b, var_rb;          // stdRange^2, stdBearing^2, product
  float pd;
  float min_r, max_r, max_b;           // the in-range class
  float near_min_r, near_max_r, near_max_b;  // 0.8 min, 1.2 max, 1.2 max
  float two_pi, pi;                    // the bearing wrap
};

// torch.clamp(v, min=lo) on CUDA: NaN passes, else max(v, lo)
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dv(float a, float b) {
  return __fdiv_rn(a, b);
}
// a b + c d, both products rounded, then the sum
__device__ __forceinline__ float dot2(float a, float b, float c, float d) {
  return add(mul(a, b), mul(c, d));
}

// One element: o[0..13] the float channels in output order, *rc the class.
__device__ __forceinline__ void element(float w, float mx, float my,
                                        float p00, float p01, float p11,
                                        float px, float py, float pth,
                                        const Scalars& k, float* o, int* rc) {
  // predict_measurement: r, the wrapped bearing, dx, dy
  const float dx0 = sub(mx, px);
  const float dy0 = sub(my, py);
  const float r = sqrtf(add(mul(dx0, dx0), mul(dy0, dy0)));
  float b = fmodf(sub(atan2f(dy0, dx0), pth), k.two_pi);
  b = b > k.pi ? sub(b, k.two_pi) : b;
  b = b < -k.pi ? add(b, k.two_pi) : b;

  // range_class, 0 for an empty slot
  const float ab = fabsf(b);
  const bool in_r = r >= k.min_r && r <= k.max_r && ab <= k.max_b;
  const bool near = r >= k.near_min_r && r <= k.near_max_r &&
                    ab <= k.near_max_b;
  const int cls = w > 0.0f ? (in_r ? 1 : (near ? 2 : 0)) : 0;
  const bool in = cls == 1;

  // the benign geometry outside the update
  const float dx = in ? dx0 : 1.0f;
  const float dy = in ? dy0 : 0.0f;
  const float r2s = add(mul(dx, dx), mul(dy, dy));
  const float rs = sqrtf(r2s);
  const float j00 = dv(dx, rs);
  const float j01 = dv(dy, rs);
  const float j10 = dv(-dy, r2s);
  const float j11 = dv(dx, r2s);

  // A = J P J^T
  const float h0 = dot2(j00, p00, j01, p01);
  const float h1 = dot2(j00, p01, j01, p11);
  const float a00 = dot2(j00, h0, j01, h1);
  const float a01 = dot2(j10, h0, j11, h1);
  const float a11 = dot2(j10, dot2(j10, p00, j11, p01), j11,
                         dot2(j10, p01, j11, p11));
  const float s00 = add(a00, k.var_r);
  const float s01 = a01;
  const float s11 = add(a11, k.var_b);

  const float det_p = clamp_min(sub(mul(p00, p11), mul(p01, p01)), 0.0f);
  float det_s = add(add(add(dv(det_p, r2s), mul(a00, k.var_b)),
                        mul(a11, k.var_r)), k.var_rb);
  det_s = clamp_min(det_s, k.var_rb);

  const float si00 = dv(s11, det_s);
  const float si01 = dv(-s01, det_s);
  const float si11 = dv(s00, det_s);

  // K = P J^T S^-1
  const float t00 = dot2(p00, j00, p01, j01);
  const float t01 = dot2(p00, j10, p01, j11);
  const float t10 = dot2(p01, j00, p11, j01);
  const float t11 = dot2(p01, j10, p11, j11);
  const float g00 = dot2(t00, si00, t01, si01);
  const float g01 = dot2(t00, si01, t01, si11);
  const float g10 = dot2(t10, si00, t11, si01);
  const float g11 = dot2(t10, si01, t11, si11);

  // Joseph form: L = I - K J, L P L^T + K R K^T
  const float l00 = sub(1.0f, dot2(g00, j00, g01, j10));
  const float l01 = -dot2(g00, j01, g01, j11);
  const float l10 = -dot2(g10, j00, g11, j10);
  const float l11 = sub(1.0f, dot2(g10, j01, g11, j11));
  const float q00 = dot2(l00, p00, l01, p01);
  const float q01 = dot2(l00, p01, l01, p11);
  const float q10 = dot2(l10, p00, l11, p01);
  const float q11 = dot2(l10, p01, l11, p11);
  const float u00 = add(add(dot2(q00, l00, q01, l01),
                            mul(mul(g00, g00), k.var_r)),
                        mul(mul(g01, g01), k.var_b));
  const float u01 = add(add(dot2(q00, l10, q01, l11),
                            mul(mul(g00, g10), k.var_r)),
                        mul(mul(g01, g11), k.var_b));
  const float u11 = add(add(dot2(q10, l10, q11, l11),
                            mul(mul(g10, g10), k.var_r)),
                        mul(mul(g11, g11), k.var_b));

  o[0] = r;
  o[1] = b;
  o[2] = in ? k.pd : 0.0f;
  o[3] = g00;
  o[4] = g01;
  o[5] = g10;
  o[6] = g11;
  o[7] = u00;
  o[8] = u01;
  o[9] = u11;
  o[10] = si00;
  o[11] = si01;
  o[12] = si11;
  o[13] = logf(det_s);
  *rc = cls;
}

// V = 4: thread items are groups of four elements of one particle (F % 4
// == 0, every pointer 16-byte aligned); V = 1: single elements.
template <int V>
__global__ void __launch_bounds__(kThreads) preupdate_kernel(
    const float* __restrict__ w, const float* __restrict__ mx,
    const float* __restrict__ my, const float* __restrict__ c00,
    const float* __restrict__ c01, const float* __restrict__ c11,
    const float* __restrict__ pose, int pose_stride, float* __restrict__ out,
    int* __restrict__ rclass, int n, int F, Scalars k) {
  const long long items = n / V;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < items; i += step) {
    const int e = static_cast<int>(i) * V;
    const float* pp = pose + static_cast<long long>(e / F) * pose_stride;
    const float px = __ldg(pp), py = __ldg(pp + 1), pth = __ldg(pp + 2);
    if constexpr (V == 4) {
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(w) + i);
      const float4 mx4 = __ldg(reinterpret_cast<const float4*>(mx) + i);
      const float4 my4 = __ldg(reinterpret_cast<const float4*>(my) + i);
      const float4 a4 = __ldg(reinterpret_cast<const float4*>(c00) + i);
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(c01) + i);
      const float4 d4 = __ldg(reinterpret_cast<const float4*>(c11) + i);
      float4 o4[kOut];
      int4 rc4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float o[kOut];
        element((&w4.x)[j], (&mx4.x)[j], (&my4.x)[j], (&a4.x)[j],
                (&b4.x)[j], (&d4.x)[j], px, py, pth, k, o, &(&rc4.x)[j]);
#pragma unroll
        for (int c = 0; c < kOut; ++c) (&o4[c].x)[j] = o[c];
      }
#pragma unroll
      for (int c = 0; c < kOut; ++c)
        reinterpret_cast<float4*>(out + static_cast<long long>(c) * n)[i] =
            o4[c];
      reinterpret_cast<int4*>(rclass)[i] = rc4;
    } else {
      float o[kOut];
      element(__ldg(w + e), __ldg(mx + e), __ldg(my + e), __ldg(c00 + e),
              __ldg(c01 + e), __ldg(c11 + e), px, py, pth, k, o, rclass + e);
#pragma unroll
      for (int c = 0; c < kOut; ++c)
        out[static_cast<long long>(c) * n + e] = o[c];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// Map channels w, mx, my, c00, c01, c11 [P, F] and pose [P, pose_stride]
// (x, y, theta first), row-major float32; outputs out [14, P, F] float32
// and rclass [P, F] int32. One launch on the given stream; returns its
// cudaError_t (cudaErrorInvalidValue for a negative size, a pose row
// shorter than 3 or more than INT_MAX elements).
int phd_preupdate_launch(const float* w, const float* mx, const float* my,
                         const float* c00, const float* c01,
                         const float* c11, const float* pose,
                         int pose_stride, float* out, int* rclass, int P,
                         int F, float var_r, float var_b, float var_rb,
                         float pd, float min_r, float max_r, float max_b,
                         float near_min_r, float near_max_r,
                         float near_max_b, float two_pi, float pi,
                         void* stream) {
  if (P < 0 || F < 0 || pose_stride < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(P) * F;
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Scalars k{var_r,      var_b,      var_rb,     pd,
                  min_r,      max_r,      max_b,      near_min_r,
                  near_max_r, near_max_b, two_pi,     pi};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = F % 4 == 0 && aligned16(w) && aligned16(mx) &&
                   aligned16(my) && aligned16(c00) && aligned16(c01) &&
                   aligned16(c11) && aligned16(out) && aligned16(rclass);
  const long long items = vec ? n / 4 : n;
  const unsigned blocks =
      static_cast<unsigned>((items + kThreads - 1) / kThreads);
  if (vec)
    preupdate_kernel<4><<<blocks, kThreads, 0, st>>>(
        w, mx, my, c00, c01, c11, pose, pose_stride, out, rclass,
        static_cast<int>(n), F, k);
  else
    preupdate_kernel<1><<<blocks, kThreads, 0, st>>>(
        w, mx, my, c00, c01, c11, pose, pose_stride, out, rclass,
        static_cast<int>(n), F, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

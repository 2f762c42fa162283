// The per-(pixel, pair) alpha step the compositor kernels share: K1
// (composite_fwd.cu), K2 (composite_bwd.cu) and K5
// (composite_bwd_two_walk.cu).
//
// K5 rebuilds K1's blend decisions and per-pixel stop without reading them,
// and K2 its blend decisions below each pixel's stop, so all three must
// round every step of alpha and T alike, and the alpha >= 1/255 and
// T >= 1e-4 crossings land in the same place in each: expf (not __expf), no
// fast-math flags, and the power's FMAs written out. Left to nvcc's
// contraction, the power rounded differently where the kernel around it
// reused one of its products: K2, whose gradient code shares a dx and c dy
// with it, fused the c dy^2 term where K1 fuses the a dx^2 term (the SASS of
// both), so a pair at alpha ~ 1/255 could blend in one and not the other,
// and K2 then rebuilt that pixel's T over a pair K1 never blended. The
// intrinsics below are K1's own contraction, so K1's values are those it
// computed before. Checked on the card: K5's count of blended pairs equals
// K1's n_contrib (tests/test_torch_cuda.py, chip_smoke.py's k5 phases).
#pragma once

#include <cuda_runtime.h>

namespace r3dg {

constexpr float kAlphaMax = 0.99f;        // alpha = min(0.99, op * e^power)
constexpr float kAlphaMin = 1.f / 255.f;  // pairs below it are skipped
constexpr float kTMin = 1e-4f;            // a pixel stops once T < kTMin

// power = -0.5 (a dx^2 + c dy^2) - b dx dy, dx = mean - pixel, as
// fma(fma(a dx, dx, (c dy) dy), -0.5, -(b dx) dy).
__device__ __forceinline__ float pair_power(float dx, float dy, float ca,
                                            float cb, float cc) {
  const float q =
      __fmaf_rn(__fmul_rn(ca, dx), dx, __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fmaf_rn(q, -0.5f, -__fmul_rn(__fmul_rn(cb, dx), dy));
}

// e^{min(power, 0)}.
__device__ __forceinline__ float pair_exp(float power) {
  return expf(fminf(power, 0.f));
}

// Whether the pair is blended (its incoming T >= kTMin is the caller's test).
__device__ __forceinline__ bool pair_blends(float power, float alpha) {
  return power <= 0.f && alpha >= kAlphaMin;
}

// The transmittance after a blended pair.
__device__ __forceinline__ float transmit(float T, float alpha) {
  return T * (1.f - alpha);
}

}  // namespace r3dg

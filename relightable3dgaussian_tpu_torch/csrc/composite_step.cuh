// The per-(pixel, pair) alpha step the compositor kernels share: K1
// (composite_fwd.cu), K2 (composite_bwd.cu) and K5
// (composite_bwd_two_walk.cu).
//
// K5 rebuilds K1's blend decisions and per-pixel stop without reading them,
// so both must round every step of alpha and T alike: one expression each,
// compiled in each kernel under the same flags (expf, not __expf; no
// fast-math; nvcc's default FMA contraction), so the alpha >= 1/255 and
// T >= 1e-4 crossings land in the same place in both. The terms of the power
// share no product with the gradient code around them, so inlining gives the
// compiler no other contraction to choose. Checked on the card: K5's count of
// blended pairs equals K1's n_contrib (tests/test_torch_cuda.py,
// chip_smoke.py's k5 phases).
#pragma once

#include <cuda_runtime.h>

namespace r3dg {

constexpr float kAlphaMax = 0.99f;        // alpha = min(0.99, op * e^power)
constexpr float kAlphaMin = 1.f / 255.f;  // pairs below it are skipped
constexpr float kTMin = 1e-4f;            // a pixel stops once T < kTMin

// power = -0.5 (a dx^2 + c dy^2) - b dx dy, dx = mean - pixel.
__device__ __forceinline__ float pair_power(float dx, float dy, float ca,
                                            float cb, float cc) {
  return -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
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

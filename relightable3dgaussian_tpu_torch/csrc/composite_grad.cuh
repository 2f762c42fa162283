// The gradient reduction the backward compositor kernels share: K2
// (composite_bwd.cu) and K5 (composite_bwd_two_walk.cu).
//
// Both run one block per 16x16 tile, one thread per pixel, and walk the
// tile's pairs in batches of kPixels slots. Per pair, each pixel's 6 + A
// gradient terms (d mean x, y; d conic a, b, c; d opacity; d attrs) are
// summed across its warp with shuffles and across warps with shared-memory
// atomics into the batch's accumulator rows s_acc [6 + A][kPixels]; after
// the batch, each slot's sums go to device memory with one atomicAdd per
// nonzero term, once per (tile, gaussian).
#pragma once

#include <cuda_runtime.h>

namespace r3dg {

constexpr int kPixels = 256;                // pixels of a tile; slots of a batch
constexpr int kGeom = 6;                    // d mean x, y; d conic a, b, c; d opacity
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Adds the warp's terms of the pair in slot j to s_acc: the geometry terms gm
// and the attribute terms w * gi[a]. Every lane of the warp calls it (j is
// warp-uniform); a warp with no blended pixel skips the pair.
template <int AMAX>
__device__ __forceinline__ void reduce_pair(float* s_acc, int j, bool blended,
                                            const float (&gm)[kGeom], float w,
                                            const float (&gi)[AMAX], int A,
                                            int lane) {
  if (!__any_sync(kFullMask, blended)) return;
#pragma unroll
  for (int f = 0; f < kGeom; ++f) {
    const float v = warp_sum(gm[f]);
    if (lane == 0 && v != 0.f) atomicAdd(&s_acc[f * kPixels + j], v);
  }
#pragma unroll
  for (int a = 0; a < AMAX; ++a) {
    if (a < A) {
      const float v = warp_sum(w * gi[a]);
      if (lane == 0 && v != 0.f) atomicAdd(&s_acc[(kGeom + a) * kPixels + j], v);
    }
  }
}

// Adds slot `slot`'s sums to gaussian g's gradients in device memory.
__device__ __forceinline__ void flush_slot(const float* s_acc, int slot, int g,
                                           int A, float* g_mean2d,
                                           float* g_conic, float* g_opacity,
                                           float* g_attrs) {
  float v;
  if ((v = s_acc[0 * kPixels + slot]) != 0.f) atomicAdd(&g_mean2d[2 * g], v);
  if ((v = s_acc[1 * kPixels + slot]) != 0.f) atomicAdd(&g_mean2d[2 * g + 1], v);
  if ((v = s_acc[2 * kPixels + slot]) != 0.f) atomicAdd(&g_conic[3 * g], v);
  if ((v = s_acc[3 * kPixels + slot]) != 0.f) atomicAdd(&g_conic[3 * g + 1], v);
  if ((v = s_acc[4 * kPixels + slot]) != 0.f) atomicAdd(&g_conic[3 * g + 2], v);
  if ((v = s_acc[5 * kPixels + slot]) != 0.f) atomicAdd(&g_opacity[g], v);
  float* ga = g_attrs + static_cast<size_t>(g) * A;
  for (int a = 0; a < A; ++a)
    if ((v = s_acc[(kGeom + a) * kPixels + slot]) != 0.f) atomicAdd(&ga[a], v);
}

}  // namespace r3dg

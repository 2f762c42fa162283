// K1's blend decisions at a list of pixels, for checks only (no main path
// launches it): chip_smoke.py's k2-split phase and tests/test_torch_cuda.py
// hold K2 (composite_bwd.cu) against a float64 replay of K1's blends at the
// pixels where K1 and the plain compositor blend other pairs, and K1's walk
// state (final T, stop, count) does not say which pairs before the stop K1
// skipped at alpha < 1/255. This kernel walks each listed pixel as K1 walks
// it, pair by pair, and writes each pair's decision.
//
// The decisions are K1's by construction: the alpha step is
// composite_step.cuh's, the one K1, K2 and K5 include, with K1's own
// expression around it (composite_fwd.cu pixel_alpha: dx = mean - pixel,
// alpha = fminf(0.99, __fmul_rn(op, e^power))), and the walk's T update and
// stop are K1's (pixel_blend). The build flags are K1's (ops/_build.py). The
// walk's own final T, stop and blended count are written beside the
// decisions, and the callers hold them bitwise to K1's walk state.
//
// One thread per pixel, the tile's range read from device memory: it serves
// a few thousand pixels a check, and no speed is asked of it.
//
// Plain C interface (built by nvcc into a shared library, bound with ctypes):
// r3dg_composite_decisions returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "composite_step.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kThreads = 128;
constexpr int8_t kBlend = 1;       // ops/composite.py BLEND
constexpr int8_t kBlendAtCap = 2;  // ops/composite.py BLEND_AT_CAP

__global__ void __launch_bounds__(kThreads)
decisions_kernel(const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end,
                 const int* __restrict__ sorted_ids,
                 const float* __restrict__ mean2d,   // [P, 2]
                 const float* __restrict__ conic,    // [P, 3]
                 const float* __restrict__ opacity,  // [P]
                 const int64_t* __restrict__ pixels, int n, int tiles_x,
                 int max_len,
                 int8_t* __restrict__ codes,         // [n, max_len], zeroed
                 float* __restrict__ final_T,        // [n]
                 int* __restrict__ stop,             // [n]
                 int* __restrict__ n_contrib) {      // [n]
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int tile = static_cast<int>(pixels[i] / kPixels);
  const int p = static_cast<int>(pixels[i] % kPixels);
  const float px = static_cast<float>((tile % tiles_x) * kTile + p % kTile);
  const float py = static_cast<float>((tile / tiles_x) * kTile + p / kTile);
  const int start = tile_start[tile];
  const int len = tile_end[tile] - start;
  int8_t* row = codes + static_cast<size_t>(i) * max_len;
  float T = 1.f;
  int count = 0;
  int walked = len;
  for (int k = 0; k < len; ++k) {
    const int g = sorted_ids[start + k];
    const float dx = mean2d[2 * g] - px;
    const float dy = mean2d[2 * g + 1] - py;
    const float power = r3dg::pair_power(dx, dy, conic[3 * g],
                                         conic[3 * g + 1], conic[3 * g + 2]);
    const float raw = __fmul_rn(opacity[g], r3dg::pair_exp(power));
    const float alpha = fminf(r3dg::kAlphaMax, raw);
    if (!r3dg::pair_blends(power, alpha)) continue;
    // K2 passes no gradient to the raw alpha where raw >= 0.99.
    if (k < max_len) row[k] = raw < r3dg::kAlphaMax ? kBlend : kBlendAtCap;
    ++count;
    T = r3dg::transmit(T, alpha);
    if (T < r3dg::kTMin) {
      walked = k + 1;
      break;
    }
  }
  final_T[i] = T;
  stop[i] = walked;
  n_contrib[i] = count;
}

}  // namespace

extern "C" int r3dg_composite_decisions(
    const void* tile_start, const void* tile_end, const void* sorted_ids,
    const void* mean2d, const void* conic, const void* opacity,
    const void* pixels, int n, int tiles_x, int max_len, void* codes,
    void* final_T, void* stop, void* n_contrib, void* stream) {
  if (n <= 0) return 0;
  decisions_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_end),
      static_cast<const int*>(sorted_ids), static_cast<const float*>(mean2d),
      static_cast<const float*>(conic), static_cast<const float*>(opacity),
      static_cast<const int64_t*>(pixels), n, tiles_x, max_len,
      static_cast<int8_t*>(codes), static_cast<float*>(final_T),
      static_cast<int*>(stop), static_cast<int*>(n_contrib));
  return static_cast<int>(cudaGetLastError());
}

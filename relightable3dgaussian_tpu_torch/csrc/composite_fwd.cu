// Kernel K1: forward tile compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel relightable3dgaussian_tpu/ops/composite_pallas.py::_kernel
// (launched by composite_pallas_forward). Semantics are those of the JAX
// package's ops/composite.py::composite, which the port's plain version
// (relightable3dgaussian_tpu_torch/ops/composite.py) reproduces:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  dx = mean - pixel (integer
//   pixel coordinates, no +0.5); alpha = min(0.99, op * expf(min(power, 0)));
//   a pair is skipped where power > 0 or alpha < 1/255; the weight
//   w = alpha * T counts only while the INCOMING transmittance T >= 1e-4;
//   n_contrib counts the pairs with w > 0; all A attribute channels are
//   blended in one pass; per-gaussian weights are sums of w over pixels.
// It also writes the walk state the backward kernel K2 (composite_bwd.cu)
// starts from, per pixel: the transmittance T at which the pixel stopped,
// and the index into the tile's range one past the last pair it walked (the
// pair that took its T under 1e-4, or the range length). The JAX package's
// TPU kernel keeps the same state per tile chunk (composite_pallas_forward,
// with_walk).
// The alpha step (power, alpha, the blend test, the T update) is
// composite_step.cuh's, shared with K2 and K5: expf (not __expf) and no
// fast-math flags, so the alpha >= 1/255 and T >= 1e-4 threshold crossings
// land where the plain version puts them, and K5 rebuilds K1's decisions
// exactly.
//
// Design: one block per 16x16 tile, one thread per pixel. The block walks its
// [start, end) range of depth-sorted gaussian ids in batches of 256; each
// batch is gathered BY ID from the per-gaussian arrays into shared memory by
// the 256 threads together, then every thread walks the batch for its pixel
// with its accumulators in registers. A pixel is done once its T < 1e-4; the
// block leaves when __syncthreads_count(done) == 256, and a warp whose lanes
// are all done leaves a batch early. Weights are summed per gaussian across
// a warp with shuffles, across warps with shared-memory atomics, and added to
// global memory once per (tile, gaussian) with atomicAdd.
//
// What bounds it on the H100: per (pixel, pair) one expf and ~15 FMAs plus
// A FMAs of blending, i.e. the SM's FP32/SFU issue rate; the id-gathered
// batch loads are scattered 4-byte reads (latency-bound, one per field). The
// batch of 256 amortises each gather over the 256 pixels of the tile, and
// the early exits stop both once a tile is opaque. Pre-gathering into a
// pair-sized table (the TPU kernel's layout) is not done: it would write and
// re-read (8 + A) floats per pair through device memory.
//
// Plain C interface (built by nvcc into a shared library, bound with ctypes):
// r3dg_composite_fwd returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "composite_step.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;  // one thread per pixel
constexpr int kMaxA = 32;              // widest attribute vector taken
constexpr unsigned kFullMask = 0xffffffffu;

// A_STATIC > 0: attribute width fixed at compile time; 0: runtime a_dim <= kMaxA.
template <int A_STATIC>
__global__ void __launch_bounds__(kBlock)
composite_fwd_kernel(const int* __restrict__ tile_start,
                     const int* __restrict__ tile_end,
                     const int* __restrict__ sorted_ids,
                     const float* __restrict__ mean2d,    // [P, 2]
                     const float* __restrict__ conic,     // [P, 3]
                     const float* __restrict__ opacity,   // [P]
                     const float* __restrict__ attrs,     // [P, A]
                     int tiles_x, int a_dim,
                     float* __restrict__ image,           // [tiles, 256, A]
                     int* __restrict__ n_contrib,         // [tiles, 256]
                     float* __restrict__ weights,         // [P] or null
                     float* __restrict__ final_T,         // [tiles, 256]
                     int* __restrict__ stop) {            // [tiles, 256]
  constexpr int AMAX = A_STATIC > 0 ? A_STATIC : kMaxA;
  const int A = A_STATIC > 0 ? A_STATIC : a_dim;

  __shared__ int s_id[kBlock];
  __shared__ float s_mx[kBlock];
  __shared__ float s_my[kBlock];
  __shared__ float s_ca[kBlock];
  __shared__ float s_cb[kBlock];
  __shared__ float s_cc[kBlock];
  __shared__ float s_op[kBlock];
  __shared__ float s_w[kBlock];
  __shared__ float s_attr[AMAX * kBlock];  // [a][slot]

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float px = static_cast<float>((tile % tiles_x) * kTile + tid % kTile);
  const float py = static_cast<float>((tile / tiles_x) * kTile + tid / kTile);
  const int start = tile_start[tile];
  const int end = tile_end[tile];

  float acc[AMAX];
#pragma unroll
  for (int a = 0; a < AMAX; ++a) acc[a] = 0.f;
  float T = 1.f;
  int count = 0;
  int done = 0;
  int walked = end - start;  // one past the last pair walked, in the range

  for (int base = start; base < end; base += kBlock) {
    // Barrier for the previous batch's readers, and the block-wide exit vote.
    if (__syncthreads_count(done) == kBlock) break;
    const int idx = base + tid;
    if (idx < end) {
      const int g = sorted_ids[idx];
      s_id[tid] = g;
      s_mx[tid] = mean2d[2 * g];
      s_my[tid] = mean2d[2 * g + 1];
      s_ca[tid] = conic[3 * g];
      s_cb[tid] = conic[3 * g + 1];
      s_cc[tid] = conic[3 * g + 2];
      s_op[tid] = opacity[g];
      const float* ag = attrs + static_cast<size_t>(g) * A;
#pragma unroll
      for (int a = 0; a < AMAX; ++a)
        if (a < A) s_attr[a * kBlock + tid] = ag[a];
    }
    if (weights != nullptr) s_w[tid] = 0.f;
    __syncthreads();

    const int n = min(kBlock, end - base);
    for (int j = 0; j < n; ++j) {
      if (__all_sync(kFullMask, done)) break;  // warp-uniform: j, n are
      float w = 0.f;
      if (!done) {
        const float dx = s_mx[j] - px;
        const float dy = s_my[j] - py;
        const float power = r3dg::pair_power(dx, dy, s_ca[j], s_cb[j], s_cc[j]);
        const float alpha =
            fminf(r3dg::kAlphaMax, __fmul_rn(s_op[j], r3dg::pair_exp(power)));
        if (r3dg::pair_blends(power, alpha)) {
          w = alpha * T;  // incoming T >= 1e-4 here (else done)
#pragma unroll
          for (int a = 0; a < AMAX; ++a)
            if (a < A) acc[a] += w * s_attr[a * kBlock + j];
          count += (w > 0.f);
          T = r3dg::transmit(T, alpha);
          done = T < r3dg::kTMin;
          if (done) walked = base + j + 1 - start;
        }
      }
      if (weights != nullptr) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          w += __shfl_xor_sync(kFullMask, w, off);
        if (lane == 0 && w != 0.f) atomicAdd(&s_w[j], w);
      }
    }
    if (weights != nullptr) {
      __syncthreads();
      if (tid < n && s_w[tid] != 0.f) atomicAdd(&weights[s_id[tid]], s_w[tid]);
    }
  }

  const size_t pix = static_cast<size_t>(tile) * kBlock + tid;
#pragma unroll
  for (int a = 0; a < AMAX; ++a)
    if (a < A) image[pix * A + a] = acc[a];
  n_contrib[pix] = count;
  final_T[pix] = T;
  stop[pix] = walked;
}

}  // namespace

extern "C" int r3dg_composite_fwd(const void* tile_start, const void* tile_end,
                                  const void* sorted_ids, const void* mean2d,
                                  const void* conic, const void* opacity,
                                  const void* attrs, int num_tiles, int tiles_x,
                                  int a_dim, void* image, void* n_contrib,
                                  void* weights, void* final_T, void* stop,
                                  void* stream) {
  if (num_tiles <= 0) return 0;
  if (a_dim < 1 || a_dim > kMaxA) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ts = static_cast<const int*>(tile_start);
  const auto* te = static_cast<const int*>(tile_end);
  const auto* ids = static_cast<const int*>(sorted_ids);
  const auto* m = static_cast<const float*>(mean2d);
  const auto* c = static_cast<const float*>(conic);
  const auto* o = static_cast<const float*>(opacity);
  const auto* at = static_cast<const float*>(attrs);
  auto* img = static_cast<float*>(image);
  auto* cnt = static_cast<int*>(n_contrib);
  auto* wts = static_cast<float*>(weights);
  auto* ft = static_cast<float*>(final_T);
  auto* st = static_cast<int*>(stop);
  auto s = static_cast<cudaStream_t>(stream);
  if (a_dim == 9) {  // the stage-1 render: rgb 3 + [normal, depth^2] 4 + depth + 1
    composite_fwd_kernel<9><<<num_tiles, kBlock, 0, s>>>(
        ts, te, ids, m, c, o, at, tiles_x, a_dim, img, cnt, wts, ft, st);
  } else {
    composite_fwd_kernel<0><<<num_tiles, kBlock, 0, s>>>(
        ts, te, ids, m, c, o, at, tiles_x, a_dim, img, cnt, wts, ft, st);
  }
  return static_cast<int>(cudaGetLastError());
}

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
// What bounds it on the H100. Per (pixel, pair) the arithmetic is one expf
// and about 15 FP32 operations, 3 + 2A more where the pair blends: some 9
// clocks of a warp's FP32 issue at A = 9. With one pixel per thread each
// pair cost the warp 6 + A separate 4-byte shared loads (15 at A = 9), and
// an SM serves one warp-wide shared load a clock; where weights are summed
// (every train render), a 5-shuffle warp sum and a shared atomic (a
// compare-and-swap loop on Hopper) per pair, each step waiting on the one
// before. The batch gather by id stalled the whole block at its barrier.
// What is left is the arithmetic itself, which composite_step.cuh fixes.
//
// Design: one 128-thread block per 16x16 tile, two pixels per thread,
// (x, y) and (x ^ 1, y + 1) with y even, so a warp covers a 16 x 4 strip and
// each pair's record, loaded once from shared memory, serves two pixels.
// The two pixels differ in x and in y, so no product of the alpha step is
// common to both and the compiler builds each pixel's expression as it does
// in K5, which rebuilds K1's decisions with one pixel per thread. The block
// walks its [start, end) range of depth-sorted ids in batches of 128,
// staged by composite_batch.cuh as packed float4 records (2 + ceil(A / 4)
// broadcast 16-byte loads a pair) with cp.async: the next batch's copies
// are in flight while the block walks the current one. A warp walks a batch
// in groups of 8 pairs: first the 16 alpha steps of the group, which depend
// on no walk state, so their expf chains overlap; then the blends in depth
// order, where only T and the accumulators wait on the pair before. Each
// pixel's alpha step, T update, done and stop are those of a walk pair by
// pair. The group's weights (a lane's two pixels' w added first) are summed
// across the warp in one 8-wide reduce-scatter (composite_warp.cuh: 9
// shuffles in 5 steps and one shared atomic for 8 pairs, where each pair
// took 5 dependent shuffles and an atomic), skipped where no pixel of the
// warp blended; warp sums meet in shared memory and go to device memory
// once per (tile, gaussian) with atomicAdd. A warp whose pixels are all
// done leaves a batch early, and the block leaves once every pixel is done
// (__syncthreads_count). Builds for A = 9 (stage 1), 8 (stage-2 train) and
// 32 (stage-2 eval) keep the accumulators in registers at their width;
// other widths take the general build (A <= 32). Pre-gathering into a
// pair-sized table (the TPU kernel's layout) is not done: it would write
// and re-read (8 + A) floats per pair through device memory.
//
// Plain C interface (built by nvcc into a shared library, bound with ctypes):
// r3dg_composite_fwd returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "composite_batch.cuh"
#include "composite_step.cuh"
#include "composite_warp.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kThreads = 128;          // two pixels per thread
constexpr int kBatch = r3dg::kBatch;   // one slot staged per thread
constexpr int kMaxA = 32;              // widest attribute vector taken
constexpr int kGroup = 8;              // pairs whose alpha steps run together
constexpr unsigned kFullMask = r3dg::kFullMask;
static_assert(kBatch == kThreads, "one slot per thread");
static_assert(kBatch % kGroup == 0, "groups tile a batch");

// Two batch buffers and the per-slot weight sums.
inline size_t shared_bytes(int a_dim) {
  return 2 * static_cast<size_t>(r3dg::batch_float4s(a_dim)) * sizeof(float4) +
         kBatch * sizeof(float);
}

// One pixel's state along the walk.
template <int AMAX>
struct Pixel {
  float acc[AMAX];
  float T;
  int count;
  bool done;
  int walked;  // one past the last pair walked, in the range
};

// The pixel's alpha for the pair; whether it blends.
__device__ __forceinline__ bool pixel_alpha(bool done, float mx, float my,
                                            float px, float py, float ca,
                                            float cb, float cc, float op,
                                            float& alpha) {
  alpha = 0.f;
  if (done) return false;
  const float dx = mx - px;
  const float dy = my - py;
  const float power = r3dg::pair_power(dx, dy, ca, cb, cc);
  alpha = fminf(r3dg::kAlphaMax, __fmul_rn(op, r3dg::pair_exp(power)));
  return r3dg::pair_blends(power, alpha);
}

// Blends the pair into a pixel that blends it (incoming T >= 1e-4, else the
// pixel is done); returns its weight w.
template <int AMAX, int NAT>
__device__ __forceinline__ float pixel_blend(Pixel<AMAX>& px, float alpha,
                                             const float (&at)[NAT], int A,
                                             int index) {
  const float w = alpha * px.T;
#pragma unroll
  for (int a = 0; a < AMAX; ++a)
    if (a < A) px.acc[a] += w * at[a];
  px.count += (w > 0.f);
  px.T = r3dg::transmit(px.T, alpha);
  px.done = px.T < r3dg::kTMin;
  if (px.done) px.walked = index + 1;
  return w;
}

template <int AMAX>
__device__ __forceinline__ void write_pixel(const Pixel<AMAX>& px, size_t pix,
                                            int A, float* image,
                                            int* n_contrib, float* final_T,
                                            int* stop) {
#pragma unroll
  for (int a = 0; a < AMAX; ++a)
    if (a < A) image[pix * A + a] = px.acc[a];
  n_contrib[pix] = px.count;
  final_T[pix] = px.T;
  stop[pix] = px.walked;
}

// A_STATIC > 0: attribute width fixed at compile time; 0: runtime a_dim <= kMaxA.
template <int A_STATIC>
__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const int* __restrict__ tile_start,
                     const int* __restrict__ tile_end,
                     const int* __restrict__ sorted_ids,
                     const r3dg::BatchSource src, int tiles_x,
                     float* __restrict__ image,           // [tiles, 256, A]
                     int* __restrict__ n_contrib,         // [tiles, 256]
                     float* __restrict__ weights,         // [P] or null
                     float* __restrict__ final_T,         // [tiles, 256]
                     int* __restrict__ stop) {            // [tiles, 256]
  constexpr int AMAX = A_STATIC > 0 ? A_STATIC : kMaxA;
  constexpr int NAT = 4 * r3dg::attr_quads(AMAX);
  const int A = A_STATIC > 0 ? A_STATIC : src.a_dim;

  extern __shared__ __align__(16) unsigned char smem[];
  float4* buf0 = reinterpret_cast<float4*>(smem);
  float4* buf1 = buf0 + r3dg::batch_float4s(A);
  float* s_w = reinterpret_cast<float*>(buf1 + r3dg::batch_float4s(A));

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int x0 = tid % kTile, y0 = 2 * (tid / kTile);
  const int tx = (tile % tiles_x) * kTile, ty = (tile / tiles_x) * kTile;
  const float px0 = static_cast<float>(tx + x0);
  const float py0 = static_cast<float>(ty + y0);
  const float px1 = static_cast<float>(tx + (x0 ^ 1));
  const float py1 = static_cast<float>(ty + y0 + 1);
  const int start = tile_start[tile];
  const int end = tile_end[tile];

  Pixel<AMAX> p0, p1;
#pragma unroll
  for (int a = 0; a < AMAX; ++a) p0.acc[a] = p1.acc[a] = 0.f;
  p0.T = p1.T = 1.f;
  p0.count = p1.count = 0;
  p0.done = p1.done = false;
  p0.walked = p1.walked = end - start;
  if (weights != nullptr) s_w[tid] = 0.f;

  const int n_batches = (end - start + kBatch - 1) / kBatch;
  // The id of this thread's slot in batch b, or -1.
  auto slot_id = [&](int b) {
    const int idx = start + b * kBatch + tid;
    return b < n_batches && idx < end ? sorted_ids[idx] : -1;
  };
  int g = slot_id(0);
  if (g >= 0) r3dg::stage_record<A_STATIC>(buf0, tid, g, src);
  r3dg::cp_async_commit();
  g = slot_id(1);

  for (int b = 0; b < n_batches; ++b) {
    // Barrier for the previous batch's readers (the other buffer, s_w), and
    // the block-wide exit vote.
    if (__syncthreads_count(p0.done && p1.done) == kThreads) break;
    const float4* cur = (b & 1) ? buf1 : buf0;
    if (g >= 0)
      r3dg::stage_record<A_STATIC>((b & 1) ? buf0 : buf1, tid, g, src);
    r3dg::cp_async_commit();
    g = slot_id(b + 2);
    r3dg::cp_async_wait<1>();  // this thread's copies of batch b have landed
    __syncthreads();           // and every thread's

    const int base = b * kBatch;  // in the range
    const int n = min(kBatch, end - start - base);
    for (int j0 = 0; j0 < n; j0 += kGroup) {
      // warp-uniform: j0, n are
      if (__all_sync(kFullMask, p0.done && p1.done)) break;
      // The group's alpha steps depend on no walk state: their expf chains
      // overlap. A pixel done before the group, or a slot past the batch,
      // computes none.
      float alpha0[kGroup], alpha1[kGroup];
      bool b0[kGroup], b1[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float4 geo0 = cur[j0 + u], geo1 = cur[kBatch + j0 + u];
        const bool past = j0 + u >= n;
        b0[u] = pixel_alpha(p0.done || past, geo0.x, geo0.y, px0, py0, geo0.z,
                            geo0.w, geo1.x, geo1.y, alpha0[u]);
        b1[u] = pixel_alpha(p1.done || past, geo0.x, geo0.y, px1, py1, geo0.z,
                            geo0.w, geo1.x, geo1.y, alpha1[u]);
      }
      // The blends, in depth order, while the pixel is not done.
      float w[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const bool c0 = b0[u] && !p0.done, c1 = b1[u] && !p1.done;
        w[u] = 0.f;
        if (c0 || c1) {
          float at[NAT];
          r3dg::load_attrs<AMAX>(cur, j0 + u, A, at);
          if (c0) w[u] += pixel_blend(p0, alpha0[u], at, A, base + j0 + u);
          if (c1) w[u] += pixel_blend(p1, alpha1[u], at, A, base + j0 + u);
        }
      }
      if (weights != nullptr) {
        bool any = false;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) any |= w[u] != 0.f;
        if (__any_sync(kFullMask, any)) {
          // lanes 4u .. 4u + 3 hold the warp's sum for pair j0 + u
          const float sum = r3dg::reduce_scatter(w, lane);
          if ((lane & 3) == 0 && sum != 0.f)
            atomicAdd(&s_w[j0 + (lane >> 2)], sum);
        }
      }
    }
    if (weights != nullptr) {
      __syncthreads();
      if (tid < n && s_w[tid] != 0.f) {
        atomicAdd(&weights[__float_as_int(cur[kBatch + tid].w)], s_w[tid]);
        s_w[tid] = 0.f;
      }
    }
  }
  r3dg::cp_async_wait<0>();

  const size_t pix0 = static_cast<size_t>(tile) * kPixels + y0 * kTile + x0;
  const size_t pix1 =
      static_cast<size_t>(tile) * kPixels + (y0 + 1) * kTile + (x0 ^ 1);
  write_pixel(p0, pix0, A, image, n_contrib, final_T, stop);
  write_pixel(p1, pix1, A, image, n_contrib, final_T, stop);
}

template <int A_STATIC>
cudaError_t launch(int num_tiles, cudaStream_t s, const int* ts, const int* te,
                   const int* ids, const r3dg::BatchSource& src, int tiles_x,
                   float* img, int* cnt, float* wts, float* ft, int* st) {
  const size_t smem = shared_bytes(src.a_dim);
  cudaError_t err = cudaFuncSetAttribute(
      composite_fwd_kernel<A_STATIC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  composite_fwd_kernel<A_STATIC><<<num_tiles, kThreads, smem, s>>>(
      ts, te, ids, src, tiles_x, img, cnt, wts, ft, st);
  return cudaGetLastError();
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
  const r3dg::BatchSource src{
      static_cast<const float*>(mean2d), static_cast<const float*>(conic),
      static_cast<const float*>(opacity), nullptr,
      static_cast<const float*>(attrs), a_dim,
      (reinterpret_cast<uintptr_t>(mean2d) & 7) == 0,
      a_dim % 4 == 0 && (reinterpret_cast<uintptr_t>(attrs) & 15) == 0};
  auto* img = static_cast<float*>(image);
  auto* cnt = static_cast<int*>(n_contrib);
  auto* wts = static_cast<float*>(weights);
  auto* ft = static_cast<float*>(final_T);
  auto* st = static_cast<int*>(stop);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // The widths built apart: ops/composite_cuda.py SPECIALISED_WIDTHS.
  switch (a_dim) {
    case 9:  // stage 1: rgb 3 + [normal, depth^2] 4 + depth + 1
      err = launch<9>(num_tiles, s, ts, te, ids, src, tiles_x, img, cnt, wts,
                      ft, st);
      break;
    case 8:  // stage-2 train (STAGE2_NERF_SYNTHETIC): rgb 3 + pbr 3 + depth + 1
      err = launch<8>(num_tiles, s, ts, te, ids, src, tiles_x, img, cnt, wts,
                      ft, st);
      break;
    case 32:  // stage-2 eval: rgb 3 + 27 features + depth + 1
      err = launch<32>(num_tiles, s, ts, te, ids, src, tiles_x, img, cnt, wts,
                       ft, st);
      break;
    default:
      err = launch<0>(num_tiles, s, ts, te, ids, src, tiles_x, img, cnt, wts,
                      ft, st);
  }
  return static_cast<int>(err);
}

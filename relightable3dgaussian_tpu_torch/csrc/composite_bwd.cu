// Kernel K2: backward tile compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel
// relightable3dgaussian_tpu/ops/composite_pallas_bwd.py::_bwd_kernel_single
// (launched by composite_pallas_backward with the forward's walk state). It
// computes the vector-Jacobian product of the forward compositor K1
// (composite_fwd.cu), i.e. of the JAX package's ops/composite.py::composite:
// given the cotangents of the tile image g_img [tiles, 256, A] and of the
// per-gaussian weights g_w [P], it returns d/d mean2d [P, 2], d/d conic
// [P, 3], d/d opacity [P] and d/d attrs [P, A].
//
// Per pixel, one walk back to front from K1's walk state (the final T and
// the stop index):
//   - alpha, power and the skip test are recomputed exactly as in K1;
//   - a pair is blended when its index is below the pixel's stop index (the
//     forward's decision, not a recomputed T >= 1e-4 test);
//   - the incoming transmittance is rebuilt by division,
//     T_i = T_{i+1} / (1 - alpha_i); alpha <= 0.99 bounds each factor;
//   - d_i = sum_a attr_a g_img_a + g_w[i] over all A channels (the constant-1
//     opacity channel included), S_i = sum_{k>i} w_k d_k carried along;
//   - g_alpha = T_i d_i - S_i / (1 - alpha_i); g_raw = g_alpha where the raw
//     alpha op * e^power is below the 0.99 cap; it chains into the opacity
//     (g_raw e^power), the power (g_raw raw) and from there into the conic
//     and the mean; g_attr = w_i g_img.
// The alpha step is composite_step.cuh's, as in K1: expf (not __expf).
//
// Design: one block per 16x16 tile, one thread per pixel. The block walks
// its range in reverse, in batches of 256 pairs, starting from the largest
// stop index among its pixels. Each batch's per-gaussian data (mean, conic,
// opacity, g_w, A attributes) is gathered by id into shared memory. Per pair
// the 6 + A gradient terms are summed across each warp with shuffles (a
// warp with no blended pixel skips the pair), across warps with
// shared-memory atomics, and added to device memory once per
// (tile, gaussian) with atomicAdd: composite_grad.cuh's reduction, shared
// with K5.
//
// What bounds it on the H100: the per-(pixel, pair) arithmetic is one expf,
// one division and ~30 FP32 operations, but each (warp, pair) with a
// blended pixel costs 5 shuffles and one shared atomic for each of the
// 6 + A terms, and the per-(tile, gaussian) float atomics into [P, 6 + A]
// are scattered; the longest (centre) tiles walk serially in one block and
// set the tail. The TPU kernel's pair-sized data table, roll-based scans and
// per-tile private rows are not carried over.
//
// Plain C interface (built by nvcc into a shared library, bound with ctypes):
// r3dg_composite_bwd returns the first CUDA error, or 0.

#include <cuda_runtime.h>

#include "composite_grad.cuh"
#include "composite_step.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;  // one thread per pixel; pairs per batch
constexpr int kMaxA = 32;              // widest attribute vector taken
constexpr int kGeom = r3dg::kGeom;
static_assert(kBlock == r3dg::kPixels, "one slot per pixel");

// Shared memory, in floats of kBlock each: id, mean x, mean y, conic a, b, c,
// opacity, g_w (8 rows), then A attribute rows, then 6 + A gradient rows.
inline size_t shared_bytes(int a_dim) {
  return static_cast<size_t>(8 + a_dim + kGeom + a_dim) * kBlock * sizeof(float);
}

// A_STATIC > 0: attribute width fixed at compile time; 0: runtime a_dim <= kMaxA.
template <int A_STATIC>
__global__ void __launch_bounds__(kBlock)
composite_bwd_kernel(const int* __restrict__ tile_start,
                     const int* __restrict__ sorted_ids,
                     const float* __restrict__ mean2d,    // [P, 2]
                     const float* __restrict__ conic,     // [P, 3]
                     const float* __restrict__ opacity,   // [P]
                     const float* __restrict__ attrs,     // [P, A]
                     const float* __restrict__ final_T,   // [tiles, 256]
                     const int* __restrict__ stop,        // [tiles, 256]
                     const float* __restrict__ g_image,   // [tiles, 256, A]
                     const float* __restrict__ g_weights, // [P] or null
                     int tiles_x, int a_dim,
                     float* __restrict__ g_mean2d,        // [P, 2]
                     float* __restrict__ g_conic,         // [P, 3]
                     float* __restrict__ g_opacity,       // [P]
                     float* __restrict__ g_attrs) {       // [P, A]
  constexpr int AMAX = A_STATIC > 0 ? A_STATIC : kMaxA;
  const int A = A_STATIC > 0 ? A_STATIC : a_dim;

  extern __shared__ float smem[];
  int* s_id = reinterpret_cast<int*>(smem);
  float* s_mx = smem + 1 * kBlock;
  float* s_my = smem + 2 * kBlock;
  float* s_ca = smem + 3 * kBlock;
  float* s_cb = smem + 4 * kBlock;
  float* s_cc = smem + 5 * kBlock;
  float* s_op = smem + 6 * kBlock;
  float* s_gw = smem + 7 * kBlock;
  float* s_attr = smem + 8 * kBlock;        // [a][slot]
  float* s_acc = s_attr + A * kBlock;       // [6 + a][slot]
  __shared__ int s_last;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float px = static_cast<float>((tile % tiles_x) * kTile + tid % kTile);
  const float py = static_cast<float>((tile / tiles_x) * kTile + tid / kTile);
  const int start = tile_start[tile];
  const size_t pix = static_cast<size_t>(tile) * kBlock + tid;

  const int my_stop = start + stop[pix];  // pairs at or past it are not walked
  float T = final_T[pix];                 // T after the pair before idx
  float S = 0.f;                          // sum over walked k > idx of w_k d_k
  float gi[AMAX];
#pragma unroll
  for (int a = 0; a < AMAX; ++a) gi[a] = a < A ? g_image[pix * A + a] : 0.f;

  if (tid == 0) s_last = start;
  __syncthreads();
  atomicMax(&s_last, my_stop);
  __syncthreads();
  const int last = s_last;
  const int n_acc = kGeom + A;

  for (int hi = last; hi > start; hi -= kBlock) {
    const int lo = max(start, hi - kBlock);
    const int n = hi - lo;
    __syncthreads();  // the previous batch's flush has read s_id and s_acc
    if (tid < n) {
      const int g = sorted_ids[lo + tid];
      s_id[tid] = g;
      s_mx[tid] = mean2d[2 * g];
      s_my[tid] = mean2d[2 * g + 1];
      s_ca[tid] = conic[3 * g];
      s_cb[tid] = conic[3 * g + 1];
      s_cc[tid] = conic[3 * g + 2];
      s_op[tid] = opacity[g];
      s_gw[tid] = g_weights != nullptr ? g_weights[g] : 0.f;
      const float* ag = attrs + static_cast<size_t>(g) * A;
#pragma unroll
      for (int a = 0; a < AMAX; ++a)
        if (a < A) s_attr[a * kBlock + tid] = ag[a];
    }
    for (int f = 0; f < n_acc; ++f) s_acc[f * kBlock + tid] = 0.f;
    __syncthreads();

    for (int j = n - 1; j >= 0; --j) {  // warp-uniform: j, n are
      float gm[kGeom] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float w = 0.f;
      bool blended = false;
      if (lo + j < my_stop) {
        const float dx = s_mx[j] - px;
        const float dy = s_my[j] - py;
        const float ca = s_ca[j], cb = s_cb[j], cc = s_cc[j];
        const float power = r3dg::pair_power(dx, dy, ca, cb, cc);
        const float e = r3dg::pair_exp(power);
        const float raw = __fmul_rn(s_op[j], e);
        const float alpha = fminf(r3dg::kAlphaMax, raw);
        if (r3dg::pair_blends(power, alpha)) {
          blended = true;
          const float one_minus = 1.f - alpha;
          T = T / one_minus;  // incoming transmittance of this pair
          w = alpha * T;
          float d = s_gw[j];
#pragma unroll
          for (int a = 0; a < AMAX; ++a)
            if (a < A) d += s_attr[a * kBlock + j] * gi[a];
          const float g_alpha = T * d - S / one_minus;
          S += w * d;
          const float g_raw = raw < 0.99f ? g_alpha : 0.f;
          const float g_power = g_raw * raw;
          gm[0] = -g_power * (ca * dx + cb * dy);
          gm[1] = -g_power * (cc * dy + cb * dx);
          gm[2] = g_power * (-0.5f * dx * dx);
          gm[3] = g_power * (-dx * dy);
          gm[4] = g_power * (-0.5f * dy * dy);
          gm[5] = g_raw * e;
        }
      }
      r3dg::reduce_pair(s_acc, j, blended, gm, w, gi, A, lane);
    }
    __syncthreads();
    if (tid < n)
      r3dg::flush_slot(s_acc, tid, s_id[tid], A, g_mean2d, g_conic, g_opacity,
                       g_attrs);
  }
}

template <int A_STATIC>
cudaError_t launch(int num_tiles, int a_dim, cudaStream_t s,
                   const int* ts, const int* ids, const float* m,
                   const float* c, const float* o, const float* at,
                   const float* ft, const int* st, const float* gimg,
                   const float* gw, int tiles_x, float* gm, float* gc,
                   float* go, float* ga) {
  const size_t smem = shared_bytes(a_dim);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel<A_STATIC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  composite_bwd_kernel<A_STATIC><<<num_tiles, kBlock, smem, s>>>(
      ts, ids, m, c, o, at, ft, st, gimg, gw, tiles_x, a_dim, gm, gc, go, ga);
  return cudaGetLastError();
}

}  // namespace

extern "C" int r3dg_composite_bwd(const void* tile_start,
                                  const void* sorted_ids, const void* mean2d,
                                  const void* conic, const void* opacity,
                                  const void* attrs, const void* final_T,
                                  const void* stop, const void* g_image,
                                  const void* g_weights, int num_tiles,
                                  int tiles_x, int a_dim, void* g_mean2d,
                                  void* g_conic, void* g_opacity,
                                  void* g_attrs, void* stream) {
  if (num_tiles <= 0) return 0;
  if (a_dim < 1 || a_dim > kMaxA) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ts = static_cast<const int*>(tile_start);
  const auto* ids = static_cast<const int*>(sorted_ids);
  const auto* m = static_cast<const float*>(mean2d);
  const auto* c = static_cast<const float*>(conic);
  const auto* o = static_cast<const float*>(opacity);
  const auto* at = static_cast<const float*>(attrs);
  const auto* ft = static_cast<const float*>(final_T);
  const auto* st = static_cast<const int*>(stop);
  const auto* gimg = static_cast<const float*>(g_image);
  const auto* gw = static_cast<const float*>(g_weights);
  auto* gm = static_cast<float*>(g_mean2d);
  auto* gc = static_cast<float*>(g_conic);
  auto* go = static_cast<float*>(g_opacity);
  auto* ga = static_cast<float*>(g_attrs);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      a_dim == 9  // the stage-1 render: rgb 3 + [normal, depth^2] 4 + depth + 1
          ? launch<9>(num_tiles, a_dim, s, ts, ids, m, c, o, at, ft, st,
                      gimg, gw, tiles_x, gm, gc, go, ga)
          : launch<0>(num_tiles, a_dim, s, ts, ids, m, c, o, at, ft, st,
                      gimg, gw, tiles_x, gm, gc, go, ga);
  return static_cast<int>(err);
}

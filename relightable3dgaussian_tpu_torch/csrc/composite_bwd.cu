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
//   - the incoming transmittance is rebuilt by the reciprocal,
//     T_i = T_{i+1} * (1 / (1 - alpha_i)), rounded to nearest at each step;
//     alpha <= 0.99 bounds each factor;
//   - d_i = sum_a attr_a g_img_a + g_w[i] over all A channels (the constant-1
//     opacity channel included), S_i = sum_{k>i} w_k d_k carried along;
//   - g_alpha = T_i d_i - S_i (1 / (1 - alpha_i)); g_raw = g_alpha where
//     the raw alpha op * e^power is below the 0.99 cap; it chains into the opacity
//     (g_raw e^power), the power (g_raw raw) and from there into the conic
//     and the mean; g_attr = w_i g_img.
// The alpha step is composite_step.cuh's, as in K1: expf (not __expf).
//
// What bounds it on the H100. The per-(pixel, pair) arithmetic is one expf,
// one reciprocal and about 27 + 3A FP32 operations. The sum of each pair's
// 6 + A terms over the tile's pixels is what cost the most: summed per term
// with 5-step warp butterflies it took 75 shuffles and 15 shared atomics
// (compare-and-swap loops, serial on lane 0) per (warp, pair) at A = 9,
// against about 17 clocks of the warp's FP32 work, and an SM retires one
// warp shuffle a clock. Beside it, the pair's fields were 8 + A separate
// 4-byte shared loads, every batch zeroed and flushed all (6 + A) x 256
// accumulators, and each pair's division, T_{i+1} / (1 - alpha_i), sat on
// the walk's critical path.
//
// Design: one 128-thread block per 16x16 tile, two pixels per thread,
// (x, y) and (x ^ 1, y + 1) with y even, so a warp covers a 16 x 4 strip.
// The block walks its range in reverse, in batches of 128 pairs from the
// largest stop index among its pixels, each warp from its own largest; the
// batches are staged by composite_batch.cuh as packed float4 records
// (2 + ceil(A / 4) loads a pair) with cp.async, the next one while the block
// walks the current one. A warp takes a batch in groups of 4 pairs (2 in the
// general build): first, for every pair of the group, what does not wait on
// the walk (the alpha step, 1 / (1 - alpha), the dot product d), so these
// overlap; then back over the group in order, where only T and S chain from
// pair to pair. A lane adds its two pixels' terms before the warp sums
// them, so each reduction serves 64 pixels, and two pairs go into one
// 32-wide reduce-scatter (composite_grad.cuh's two-pair reduce_pair: 31
// shuffles in 5 steps and one warp-wide shared atomic for 2 x 16 terms; 14
// and 15 terms at A = 8 and 9 fit one chunk) into a row per slot; only
// slots a pixel blended are flushed to device memory (one atomicAdd per
// nonzero term, once per (tile, gaussian)) and zeroed. Builds for A = 9 (stage 1) and
// A = 8 (stage-2 train) hold the terms and cotangents in registers at their
// width; other widths take the general build (A <= 32). The TPU kernel's
// pair-sized data table, roll-based scans and per-tile private rows are
// not carried over.
//
// Plain C interface (built by nvcc into a shared library, bound with ctypes):
// r3dg_composite_bwd returns the first CUDA error, or 0.

#include <cstdint>

#include <cuda_runtime.h>

#include "composite_batch.cuh"
#include "composite_grad.cuh"
#include "composite_step.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kThreads = 128;          // two pixels per thread
constexpr int kBatch = r3dg::kBatch;   // one slot staged per thread
constexpr int kMaxA = 32;              // widest attribute vector taken
constexpr int kGeom = r3dg::kGeom;
constexpr unsigned kFullMask = r3dg::kFullMask;
static_assert(kBatch == kThreads, "one slot per thread");

// Two batch buffers, the accumulator rows and the touched flags.
inline size_t shared_bytes(int a_dim) {
  return 2 * static_cast<size_t>(r3dg::batch_float4s(a_dim)) * sizeof(float4) +
         static_cast<size_t>(kBatch) *
             (r3dg::acc_stride(r3dg::term_chunks(a_dim)) + 1) * sizeof(float);
}

// One pixel's alpha step for a pair it walks (dx, dy from the mean to the
// pixel), and what the walk back needs of it: whether it blends, e^power,
// the raw and the capped alpha, 1 / (1 - alpha), and d = g_w + attr . g_img.
struct PairStep {
  float dx, dy, e, raw, alpha, inv, d;
  bool blended;
};

__device__ __forceinline__ PairStep pair_step(bool walked, float mx, float my,
                                              float px, float py, float ca,
                                              float cb, float cc, float op) {
  PairStep p{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false};
  if (walked) {
    p.dx = mx - px;
    p.dy = my - py;
    const float power = r3dg::pair_power(p.dx, p.dy, ca, cb, cc);
    p.e = r3dg::pair_exp(power);
    p.raw = __fmul_rn(op, p.e);
    p.alpha = fminf(r3dg::kAlphaMax, p.raw);
    p.blended = r3dg::pair_blends(power, p.alpha);
    p.inv = __frcp_rn(1.f - p.alpha);
  }
  return p;
}

template <int AMAX, int NAT>
__device__ __forceinline__ float pair_dot(float gw, const float (&at)[NAT],
                                          const float (&gi)[AMAX], int A) {
  float d = gw;
#pragma unroll
  for (int a = 0; a < AMAX; ++a)
    if (a < A) d += at[a] * gi[a];
  return d;
}

// Steps a blended pixel's transmittance T and suffix S back over the pair
// and adds its gradient terms for the pair to `terms`.
template <int AMAX, int NT>
__device__ __forceinline__ void add_pixel_terms(const PairStep& p, float ca,
                                                float cb, float cc,
                                                const float (&gi)[AMAX], int A,
                                                float& T, float& S,
                                                float (&terms)[NT]) {
  T = T * p.inv;  // incoming transmittance of this pair
  const float w = p.alpha * T;
  const float g_alpha = T * p.d - S * p.inv;
  S += w * p.d;
  const float g_raw = p.raw < 0.99f ? g_alpha : 0.f;
  const float g_power = g_raw * p.raw;
  const float dx = p.dx, dy = p.dy;
  terms[0] += -g_power * (ca * dx + cb * dy);
  terms[1] += -g_power * (cc * dy + cb * dx);
  terms[2] += g_power * (-0.5f * dx * dx);
  terms[3] += g_power * (-dx * dy);
  terms[4] += g_power * (-0.5f * dy * dy);
  terms[5] += g_raw * p.e;
#pragma unroll
  for (int a = 0; a < AMAX; ++a)
    if (a < A) terms[kGeom + a] += w * gi[a];
}

// A_STATIC > 0: attribute width fixed at compile time; 0: runtime a_dim <= kMaxA.
template <int A_STATIC>
__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const int* __restrict__ tile_start,
                     const int* __restrict__ sorted_ids,
                     const r3dg::BatchSource src,
                     const float* __restrict__ final_T,   // [tiles, 256]
                     const int* __restrict__ stop,        // [tiles, 256]
                     const float* __restrict__ g_image,   // [tiles, 256, A]
                     int tiles_x,
                     float* __restrict__ g_mean2d,        // [P, 2]
                     float* __restrict__ g_conic,         // [P, 3]
                     float* __restrict__ g_opacity,       // [P]
                     float* __restrict__ g_attrs) {       // [P, A]
  constexpr int AMAX = A_STATIC > 0 ? A_STATIC : kMaxA;
  constexpr int NAT = 4 * r3dg::attr_quads(AMAX);
  constexpr int NT = r3dg::kChunk * r3dg::term_chunks(AMAX);
  // pairs per group: an even count, fewer where the terms take 48 registers
  constexpr int G = A_STATIC > 0 ? 4 : 2;
  const int A = A_STATIC > 0 ? A_STATIC : src.a_dim;
  const int n_chunks = r3dg::term_chunks(A);
  const int stride = r3dg::acc_stride(n_chunks);

  extern __shared__ __align__(16) unsigned char smem[];
  float4* buf0 = reinterpret_cast<float4*>(smem);
  float4* buf1 = buf0 + r3dg::batch_float4s(A);
  float* s_acc = reinterpret_cast<float*>(buf1 + r3dg::batch_float4s(A));
  int* s_touched = reinterpret_cast<int*>(s_acc + kBatch * stride);
  __shared__ int s_last;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int x0 = tid % kTile, y0 = 2 * (tid / kTile);
  const int tx = (tile % tiles_x) * kTile, ty = (tile / tiles_x) * kTile;
  const float px0 = static_cast<float>(tx + x0);
  const float py0 = static_cast<float>(ty + y0);
  const float px1 = static_cast<float>(tx + (x0 ^ 1));
  const float py1 = static_cast<float>(ty + y0 + 1);
  const size_t pix0 = static_cast<size_t>(tile) * kPixels + y0 * kTile + x0;
  const size_t pix1 =
      static_cast<size_t>(tile) * kPixels + (y0 + 1) * kTile + (x0 ^ 1);
  const int start = tile_start[tile];

  const int stop0 = start + stop[pix0];  // pairs at or past it are not walked
  const int stop1 = start + stop[pix1];
  float T0 = final_T[pix0], T1 = final_T[pix1];  // T after the pair before idx
  float S0 = 0.f, S1 = 0.f;  // sum over walked k > idx of w_k d_k
  float gi0[AMAX], gi1[AMAX];
#pragma unroll
  for (int a = 0; a < AMAX; ++a) {
    gi0[a] = a < A ? g_image[pix0 * A + a] : 0.f;
    gi1[a] = a < A ? g_image[pix1 * A + a] : 0.f;
  }

  for (int i = tid; i < kBatch * stride; i += kThreads) s_acc[i] = 0.f;
  s_touched[tid] = 0;
  if (tid == 0) s_last = start;
  __syncthreads();
  const int warp_last = __reduce_max_sync(kFullMask, max(stop0, stop1));
  if (lane == 0) atomicMax(&s_last, warp_last);
  __syncthreads();
  const int last = s_last;
  const int n_batches = (last - start + kBatch - 1) / kBatch;

  // Batch k covers [lo, hi), hi = last - k kBatch, lo = max(start, hi - kBatch);
  // slot t holds the pair at lo + t. The id of this thread's slot, or -1.
  auto slot_id = [&](int k) {
    if (k >= n_batches) return -1;
    const int hi = last - k * kBatch;
    const int idx = max(start, hi - kBatch) + tid;
    return idx < hi ? sorted_ids[idx] : -1;
  };
  int g = slot_id(0);
  if (g >= 0) r3dg::stage_record<A_STATIC>(buf0, tid, g, src);
  r3dg::cp_async_commit();
  g = slot_id(1);

  for (int k = 0; k < n_batches; ++k) {
    const float4* cur = (k & 1) ? buf1 : buf0;
    // The previous batch's walk and flush are done with the other buffer
    // and the accumulators.
    if (k > 0) __syncthreads();
    if (g >= 0)
      r3dg::stage_record<A_STATIC>((k & 1) ? buf0 : buf1, tid, g, src);
    r3dg::cp_async_commit();
    g = slot_id(k + 2);
    r3dg::cp_async_wait<1>();  // this thread's copies of batch k have landed
    __syncthreads();           // and every thread's

    const int hi = last - k * kBatch;
    const int lo = max(start, hi - kBatch);
    // The warp's pairs of the batch, slots below min(hi, warp_last) - lo,
    // top down in groups of G (slots jt, jt - 1, .., jt - G + 1; those
    // below 0 are not walked).
    for (int jt = min(hi, warp_last) - lo - 1; jt >= 0; jt -= G) {
      // Everything that does not wait on T and S: the alpha steps, their
      // reciprocals and the dot products, independent across the group.
      PairStep q0[G], q1[G];
      float ca[G], cb[G], cc[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int j = max(jt - u, 0), idx = lo + jt - u;
        const float4 geo0 = cur[j], geo1 = cur[kBatch + j];
        ca[u] = geo0.z;
        cb[u] = geo0.w;
        cc[u] = geo1.x;
        q0[u] = pair_step(jt - u >= 0 && idx < stop0, geo0.x, geo0.y, px0, py0,
                          ca[u], cb[u], cc[u], geo1.y);
        q1[u] = pair_step(jt - u >= 0 && idx < stop1, geo0.x, geo0.y, px1, py1,
                          ca[u], cb[u], cc[u], geo1.y);
        if (q0[u].blended || q1[u].blended) {
          float at[NAT];
          r3dg::load_attrs<AMAX>(cur, j, A, at);
          q0[u].d = pair_dot(geo1.z, at, gi0, A);
          q1[u].d = pair_dot(geo1.z, at, gi1, A);
        }
      }
      // Back over the group's pairs in order, two at a time into one
      // reduction: T and S are the only chain.
#pragma unroll
      for (int u = 0; u < G; u += 2) {
        float ta[NT], tb[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) ta[t] = tb[t] = 0.f;
        if (q0[u].blended)
          add_pixel_terms(q0[u], ca[u], cb[u], cc[u], gi0, A, T0, S0, ta);
        if (q1[u].blended)
          add_pixel_terms(q1[u], ca[u], cb[u], cc[u], gi1, A, T1, S1, ta);
        if (q0[u + 1].blended)
          add_pixel_terms(q0[u + 1], ca[u + 1], cb[u + 1], cc[u + 1], gi0, A,
                          T0, S0, tb);
        if (q1[u + 1].blended)
          add_pixel_terms(q1[u + 1], ca[u + 1], cb[u + 1], cc[u + 1], gi1, A,
                          T1, S1, tb);
        r3dg::reduce_pair(s_acc, stride, s_touched, jt - u,
                           q0[u].blended || q1[u].blended, ta, jt - u - 1,
                           q0[u + 1].blended || q1[u + 1].blended, tb,
                           n_chunks, lane);
      }
    }
    __syncthreads();
    if (tid < hi - lo)
      r3dg::flush_slot(s_acc, stride, s_touched, tid,
                       __float_as_int(cur[kBatch + tid].w), A, g_mean2d,
                       g_conic, g_opacity, g_attrs);
  }
  r3dg::cp_async_wait<0>();
}

template <int A_STATIC>
cudaError_t launch(int num_tiles, cudaStream_t s, const int* ts,
                   const int* ids, const r3dg::BatchSource& src,
                   const float* ft, const int* st, const float* gimg,
                   int tiles_x, float* gm, float* gc, float* go, float* ga) {
  const size_t smem = shared_bytes(src.a_dim);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel<A_STATIC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  composite_bwd_kernel<A_STATIC><<<num_tiles, kThreads, smem, s>>>(
      ts, ids, src, ft, st, gimg, tiles_x, gm, gc, go, ga);
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
  const r3dg::BatchSource src{
      static_cast<const float*>(mean2d), static_cast<const float*>(conic),
      static_cast<const float*>(opacity), static_cast<const float*>(g_weights),
      static_cast<const float*>(attrs), a_dim,
      (reinterpret_cast<uintptr_t>(mean2d) & 7) == 0,
      a_dim % 4 == 0 && (reinterpret_cast<uintptr_t>(attrs) & 15) == 0};
  const auto* ft = static_cast<const float*>(final_T);
  const auto* st = static_cast<const int*>(stop);
  const auto* gimg = static_cast<const float*>(g_image);
  auto* gm = static_cast<float*>(g_mean2d);
  auto* gc = static_cast<float*>(g_conic);
  auto* go = static_cast<float*>(g_opacity);
  auto* ga = static_cast<float*>(g_attrs);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // The widths built apart: ops/composite_cuda.py SPECIALISED_WIDTHS.
  switch (a_dim) {
    case 9:  // stage 1: rgb 3 + [normal, depth^2] 4 + depth + 1
      err = launch<9>(num_tiles, s, ts, ids, src, ft, st, gimg, tiles_x, gm,
                      gc, go, ga);
      break;
    case 8:  // stage-2 train (STAGE2_NERF_SYNTHETIC): rgb 3 + pbr 3 + depth + 1
      err = launch<8>(num_tiles, s, ts, ids, src, ft, st, gimg, tiles_x, gm,
                      gc, go, ga);
      break;
    default:
      err = launch<0>(num_tiles, s, ts, ids, src, ft, st, gimg, tiles_x, gm,
                      gc, go, ga);
  }
  return static_cast<int>(err);
}

// Kernel K5: the two-walk backward tile compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel
// relightable3dgaussian_tpu/ops/composite_pallas_bwd.py::_bwd_kernel
// (launched by composite_pallas_backward when R3DG_BWD_TWO_WALK=1). It
// computes the same vector-Jacobian product as K2 (composite_bwd.cu), the
// one of the forward compositor K1 (composite_fwd.cu): from the cotangents
// g_img [tiles, 256, A] and g_w [P], the gradients d/d mean2d [P, 2],
// d/d conic [P, 3], d/d opacity [P] and d/d attrs [P, A]. Unlike K2 it
// reads no walk state of K1: each pixel walks its pairs front to back
// twice.
//   Phase A recomputes alpha, T and w = alpha T as K1 does and sums
//     S_tot = sum_k w_k d_k,   d_k = attr_k . g_img + g_w[k]
//   over all A channels (the constant-1 opacity channel included); it also
//   finds the pixel's stop (one past the pair that took its T under 1e-4).
//   Phase B walks again up to that stop, keeps the inclusive prefix P_i of
//   the same sum,
//     g_alpha_i = T_i d_i - (S_tot - P_i) / (1 - alpha_i),
//   and from there the chain into opacity, power, conic and mean is K2's;
//   g_attr = w_i g_img.
// The alpha step is composite_step.cuh's, K1's own, so both walks rebuild
// K1's blend decisions and each pixel stops at K1's place (its T < 1e-4)
// without reading it: expf (not __expf), no fast-math, the same expression.
// d_k, S_tot and P_i are summed with explicit FMAs in the same sequential
// order in both walks, so at a pixel's last blended pair P_i equals S_tot
// exactly and no pair past the stop gets a gradient, as in the plain
// backward. (The TPU kernel sums phase A per chunk and phase B by a lane
// scan; the orders differ, and past a pixel's stop its suffix is a rounding
// residue.) Where the suffix is small beside S_tot, S_tot - P_i cancels: its
// error is about ulp(S_tot), against K2's suffix carried as its own sum.
//
// What bounded it on the H100 (the first design, one thread per pixel): each
// walk gathered the tile's ids in batches of 256 into shared memory, 8 + A
// four-byte loads a pair for each pixel and a block-wide stall at every
// gather, with no copy in flight; each pair's division and its reduction
// (one pair at a time) sat on the walk's chain.
//
// Design: K1's and K2's pieces. One 128-thread block per 16x16 tile, two
// pixels per thread, (x, y) and (x ^ 1, y + 1) with y even, so each staged
// record read from shared memory serves two pixels. Both walks take the
// batches of composite_batch.cuh: packed float4 records (2 + ceil(A / 4)
// broadcast 16-byte loads a pair) copied by cp.async one batch ahead of the
// walk. Phase A is K1's walk: groups of 8 pairs whose alpha steps, which
// depend on no walk state, run first, then the blends in depth order, where
// only T and S_tot chain; the block leaves the range once every pixel is
// done. Phase B walks only up to the block's last stop, and a warp only up
// to its own: two pairs at a time, it first computes both pairs' alpha steps
// and d, then goes over them in order, where only T and P chain, and sums
// their 6 + A terms in one 32-wide reduce-scatter (composite_grad.cuh, K2's
// reduction) into a row per slot, flushed to device memory once per (tile,
// gaussian). 1 / (1 - alpha) only scales the suffix S_tot - P_i (nothing
// chains through it, where K2 rebuilds T with it), so it is the approximate
// reciprocal, and only for blended pairs. Builds for A = 9 (stage 1) and
// A = 8 (stage-2 train) hold the cotangents and terms in registers at their
// width; other widths take the general build (A <= 32). The kernel asks for
// 3 blocks an SM (168 registers: the general build spills, the specialised
// ones take 104 and 108).
//
// What bounds it now: the per-(pixel, pair) instruction issue of the two
// walks. Phase B is K2's work (the alpha step, d, the chain, the reduction)
// and phase A adds K1's alpha steps and d for the blended pairs, about a
// third of phase B's instructions: on the H100 K5 takes about K2's time
// and a third more (chip_smoke.py's k5-main). K2's groups of 4 pairs took
// more registers here than in K2 and ran slower than groups of 2.
//
// Plain C interface (built by nvcc into a shared library, bound with ctypes):
// r3dg_composite_bwd_two_walk returns the first CUDA error, or 0.

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
constexpr int kGroupA = 8;             // phase A: alpha steps run together
constexpr int kMinBlocks = 3;          // blocks an SM holds at least
constexpr int kGeom = r3dg::kGeom;
constexpr unsigned kFullMask = r3dg::kFullMask;
static_assert(kBatch == kThreads, "one slot per thread");
static_assert(kBatch % kGroupA == 0, "groups tile a batch");

// Two batch buffers, the accumulator rows and the touched flags.
inline size_t shared_bytes(int a_dim) {
  return 2 * static_cast<size_t>(r3dg::batch_float4s(a_dim)) * sizeof(float4) +
         static_cast<size_t>(kBatch) *
             (r3dg::acc_stride(r3dg::term_chunks(a_dim)) + 1) * sizeof(float);
}

// d = g_w + sum_a attr_a g_img_a, in one fixed order with explicit FMAs:
// both walks compute it bit for bit alike.
template <int AMAX, int NAT>
__device__ __forceinline__ float pair_dot(float gw, const float (&at)[NAT],
                                          const float (&gi)[AMAX], int A) {
  float d = gw;
#pragma unroll
  for (int a = 0; a < AMAX; ++a)
    if (a < A) d = __fmaf_rn(at[a], gi[a], d);
  return d;
}

// A pixel's phase-A state: T, S_tot, its count of blended pairs, whether
// its T fell under 1e-4, and one past the last pair it walked (in the range).
struct PixelA {
  float T, S;
  int count;
  bool done;
  int walked;
};

// The pixel's alpha for the pair; whether it blends (K1's pixel_alpha).
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

// Phase A's blend of a pair the pixel blends.
__device__ __forceinline__ void blend_a(PixelA& px, float alpha, float d,
                                        int index) {
  const float w = __fmul_rn(alpha, px.T);  // incoming T >= 1e-4 here
  px.S = __fmaf_rn(w, d, px.S);
  ++px.count;
  px.T = r3dg::transmit(px.T, alpha);
  px.done = px.T < r3dg::kTMin;
  if (px.done) px.walked = index + 1;
}

// One pixel's alpha step for a pair phase B walks, and what the chain needs
// of it: whether it blends, e^power, the raw and the capped alpha, and d.
struct PairStep {
  float dx, dy, e, raw, alpha, d;
  bool blended;
};

__device__ __forceinline__ PairStep pair_step(bool walked, float mx, float my,
                                              float px, float py, float ca,
                                              float cb, float cc, float op) {
  PairStep p{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false};
  if (walked) {
    p.dx = mx - px;
    p.dy = my - py;
    const float power = r3dg::pair_power(p.dx, p.dy, ca, cb, cc);
    p.e = r3dg::pair_exp(power);
    p.raw = __fmul_rn(op, p.e);
    p.alpha = fminf(r3dg::kAlphaMax, p.raw);
    p.blended = r3dg::pair_blends(power, p.alpha);
  }
  return p;
}

// Steps a blended pixel's T and prefix P forward over the pair and adds its
// gradient terms for the pair to `terms`.
template <int AMAX, int NT>
__device__ __forceinline__ void add_pixel_terms(const PairStep& p, float ca,
                                                float cb, float cc,
                                                const float (&gi)[AMAX], int A,
                                                float s_tot, float& T,
                                                float& P, float (&terms)[NT]) {
  const float w = __fmul_rn(p.alpha, T);
  P = __fmaf_rn(w, p.d, P);
  // 1 / (1 - alpha) only scales the suffix here (T and P do not chain
  // through it, as K2's T does), so the approximate reciprocal's ulp is
  // far under the gradient gate
  const float g_alpha = T * p.d - __fdividef(s_tot - P, 1.f - p.alpha);
  const float g_raw = p.raw < r3dg::kAlphaMax ? g_alpha : 0.f;
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
  T = r3dg::transmit(T, p.alpha);
}

// A_STATIC > 0: attribute width fixed at compile time; 0: runtime a_dim <= kMaxA.
template <int A_STATIC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
composite_bwd_two_walk_kernel(const int* __restrict__ tile_start,
                              const int* __restrict__ tile_end,
                              const int* __restrict__ sorted_ids,
                              const r3dg::BatchSource src,
                              const float* __restrict__ g_image,  // [tiles, 256, A]
                              int tiles_x,
                              float* __restrict__ g_mean2d,       // [P, 2]
                              float* __restrict__ g_conic,        // [P, 3]
                              float* __restrict__ g_opacity,      // [P]
                              float* __restrict__ g_attrs,        // [P, A]
                              int* __restrict__ n_blended) {      // [tiles, 256] or null
  constexpr int AMAX = A_STATIC > 0 ? A_STATIC : kMaxA;
  constexpr int NAT = 4 * r3dg::attr_quads(AMAX);
  constexpr int NT = r3dg::kChunk * r3dg::term_chunks(AMAX);
  // phase B's pairs per group: one reduction's worth
  constexpr int G = 2;
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
  const int end = tile_end[tile];

  float gi0[AMAX], gi1[AMAX];
#pragma unroll
  for (int a = 0; a < AMAX; ++a) {
    gi0[a] = a < A ? g_image[pix0 * A + a] : 0.f;
    gi1[a] = a < A ? g_image[pix1 * A + a] : 0.f;
  }
  for (int i = tid; i < kBatch * stride; i += kThreads) s_acc[i] = 0.f;
  s_touched[tid] = 0;
  if (tid == 0) s_last = start;

  // The id of this thread's slot in batch b of the range [start, limit), or
  // -1; batch b covers [start + b kBatch, start + (b + 1) kBatch).
  auto slot_id = [&](int b, int limit) {
    const int idx = start + b * kBatch + tid;
    return idx < limit ? sorted_ids[idx] : -1;
  };

  // ---- phase A: S_tot over each pixel's blended pairs, and its stop --------
  PixelA p0{1.f, 0.f, 0, false, end - start};
  PixelA p1{1.f, 0.f, 0, false, end - start};
  const int n_batches = (end - start + kBatch - 1) / kBatch;
  int g = slot_id(0, end);
  if (g >= 0) r3dg::stage_record<A_STATIC>(buf0, tid, g, src);
  r3dg::cp_async_commit();
  g = slot_id(1, end);
  for (int b = 0; b < n_batches; ++b) {
    // Barrier for the previous batch's readers (the other buffer), and the
    // block-wide exit vote.
    if (__syncthreads_count(p0.done && p1.done) == kThreads) break;
    const float4* cur = (b & 1) ? buf1 : buf0;
    if (g >= 0)
      r3dg::stage_record<A_STATIC>((b & 1) ? buf0 : buf1, tid, g, src);
    r3dg::cp_async_commit();
    g = slot_id(b + 2, end);
    r3dg::cp_async_wait<1>();  // this thread's copies of batch b have landed
    __syncthreads();           // and every thread's

    const int base = b * kBatch;  // in the range
    const int n = min(kBatch, end - start - base);
    for (int j0 = 0; j0 < n; j0 += kGroupA) {
      // warp-uniform: j0, n are
      if (__all_sync(kFullMask, p0.done && p1.done)) break;
      float alpha0[kGroupA], alpha1[kGroupA];
      bool b0[kGroupA], b1[kGroupA];
#pragma unroll
      for (int u = 0; u < kGroupA; ++u) {
        const float4 geo0 = cur[j0 + u], geo1 = cur[kBatch + j0 + u];
        const bool past = j0 + u >= n;
        b0[u] = pixel_alpha(p0.done || past, geo0.x, geo0.y, px0, py0, geo0.z,
                            geo0.w, geo1.x, geo1.y, alpha0[u]);
        b1[u] = pixel_alpha(p1.done || past, geo0.x, geo0.y, px1, py1, geo0.z,
                            geo0.w, geo1.x, geo1.y, alpha1[u]);
      }
#pragma unroll
      for (int u = 0; u < kGroupA; ++u) {
        const bool c0 = b0[u] && !p0.done, c1 = b1[u] && !p1.done;
        if (c0 || c1) {
          float at[NAT];
          r3dg::load_attrs<AMAX>(cur, j0 + u, A, at);
          const float gw = cur[kBatch + j0 + u].z;
          if (c0) blend_a(p0, alpha0[u], pair_dot(gw, at, gi0, A), base + j0 + u);
          if (c1) blend_a(p1, alpha1[u], pair_dot(gw, at, gi1, A), base + j0 + u);
        }
      }
    }
  }
  r3dg::cp_async_wait<0>();
  if (n_blended != nullptr) {
    n_blended[pix0] = p0.count;
    n_blended[pix1] = p1.count;
  }

  // ---- phase B: the gradients, from the inclusive prefix P_i ---------------
  const int stop0 = start + p0.walked;  // pairs at or past it are not walked
  const int stop1 = start + p1.walked;
  const int warp_last = __reduce_max_sync(kFullMask, max(stop0, stop1));
  __syncthreads();  // phase A's readers are done with both buffers
  if (lane == 0) atomicMax(&s_last, warp_last);
  __syncthreads();
  const int last = s_last;
  const int nb = (last - start + kBatch - 1) / kBatch;
  g = slot_id(0, last);
  if (g >= 0) r3dg::stage_record<A_STATIC>(buf0, tid, g, src);
  r3dg::cp_async_commit();
  g = slot_id(1, last);
  float T0 = 1.f, T1 = 1.f, P0 = 0.f, P1 = 0.f;
  for (int b = 0; b < nb; ++b) {
    const float4* cur = (b & 1) ? buf1 : buf0;
    // The previous batch's walk and flush are done with the other buffer
    // and the accumulators.
    if (b > 0) __syncthreads();
    if (g >= 0)
      r3dg::stage_record<A_STATIC>((b & 1) ? buf0 : buf1, tid, g, src);
    r3dg::cp_async_commit();
    g = slot_id(b + 2, last);
    r3dg::cp_async_wait<1>();  // this thread's copies of batch b have landed
    __syncthreads();           // and every thread's

    const int lo = start + b * kBatch;
    const int n = min(kBatch, last - lo);
    // the warp's pairs of the batch: slots below min(n, warp_last - lo)
    const int jend = min(n, warp_last - lo);
    for (int j0 = 0; j0 < jend; j0 += G) {
      // Everything that does not wait on T and P: the alpha steps, their
      // reciprocals and the dot products, independent across the group.
      PairStep q0[G], q1[G];
      float ca[G], cb[G], cc[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int j = min(j0 + u, kBatch - 1), idx = lo + j0 + u;
        const bool in = j0 + u < jend;
        const float4 geo0 = cur[j], geo1 = cur[kBatch + j];
        ca[u] = geo0.z;
        cb[u] = geo0.w;
        cc[u] = geo1.x;
        q0[u] = pair_step(in && idx < stop0, geo0.x, geo0.y, px0, py0, ca[u],
                          cb[u], cc[u], geo1.y);
        q1[u] = pair_step(in && idx < stop1, geo0.x, geo0.y, px1, py1, ca[u],
                          cb[u], cc[u], geo1.y);
        if (q0[u].blended || q1[u].blended) {
          float at[NAT];
          r3dg::load_attrs<AMAX>(cur, j, A, at);
          q0[u].d = pair_dot(geo1.z, at, gi0, A);
          q1[u].d = pair_dot(geo1.z, at, gi1, A);
        }
      }
      // Over the group's pairs in order, two at a time into one reduction:
      // T and P are the only chain.
#pragma unroll
      for (int u = 0; u < G; u += 2) {
        float ta[NT], tb[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) ta[t] = tb[t] = 0.f;
        if (q0[u].blended)
          add_pixel_terms(q0[u], ca[u], cb[u], cc[u], gi0, A, p0.S, T0, P0,
                          ta);
        if (q1[u].blended)
          add_pixel_terms(q1[u], ca[u], cb[u], cc[u], gi1, A, p1.S, T1, P1,
                          ta);
        if (q0[u + 1].blended)
          add_pixel_terms(q0[u + 1], ca[u + 1], cb[u + 1], cc[u + 1], gi0, A,
                          p0.S, T0, P0, tb);
        if (q1[u + 1].blended)
          add_pixel_terms(q1[u + 1], ca[u + 1], cb[u + 1], cc[u + 1], gi1, A,
                          p1.S, T1, P1, tb);
        const int jb = j0 + u + 1 < jend ? j0 + u + 1 : -1;
        r3dg::reduce_pair(s_acc, stride, s_touched, j0 + u,
                          q0[u].blended || q1[u].blended, ta, jb,
                          q0[u + 1].blended || q1[u + 1].blended, tb,
                          n_chunks, lane);
      }
    }
    __syncthreads();
    if (tid < n)
      r3dg::flush_slot(s_acc, stride, s_touched, tid,
                       __float_as_int(cur[kBatch + tid].w), A, g_mean2d,
                       g_conic, g_opacity, g_attrs);
  }
  r3dg::cp_async_wait<0>();
}

template <int A_STATIC>
cudaError_t launch(int num_tiles, cudaStream_t s, const int* ts,
                   const int* te, const int* ids, const r3dg::BatchSource& src,
                   const float* gimg, int tiles_x, float* gm, float* gc,
                   float* go, float* ga, int* nb) {
  const size_t smem = shared_bytes(src.a_dim);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_two_walk_kernel<A_STATIC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  composite_bwd_two_walk_kernel<A_STATIC><<<num_tiles, kThreads, smem, s>>>(
      ts, te, ids, src, gimg, tiles_x, gm, gc, go, ga, nb);
  return cudaGetLastError();
}

}  // namespace

extern "C" int r3dg_composite_bwd_two_walk(
    const void* tile_start, const void* tile_end, const void* sorted_ids,
    const void* mean2d, const void* conic, const void* opacity,
    const void* attrs, const void* g_image, const void* g_weights,
    int num_tiles, int tiles_x, int a_dim, void* g_mean2d, void* g_conic,
    void* g_opacity, void* g_attrs, void* n_blended, void* stream) {
  if (num_tiles <= 0) return 0;
  if (a_dim < 1 || a_dim > kMaxA) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ts = static_cast<const int*>(tile_start);
  const auto* te = static_cast<const int*>(tile_end);
  const auto* ids = static_cast<const int*>(sorted_ids);
  const r3dg::BatchSource src{
      static_cast<const float*>(mean2d), static_cast<const float*>(conic),
      static_cast<const float*>(opacity), static_cast<const float*>(g_weights),
      static_cast<const float*>(attrs), a_dim,
      (reinterpret_cast<uintptr_t>(mean2d) & 7) == 0,
      a_dim % 4 == 0 && (reinterpret_cast<uintptr_t>(attrs) & 15) == 0};
  const auto* gimg = static_cast<const float*>(g_image);
  auto* gm = static_cast<float*>(g_mean2d);
  auto* gc = static_cast<float*>(g_conic);
  auto* go = static_cast<float*>(g_opacity);
  auto* ga = static_cast<float*>(g_attrs);
  auto* nb = static_cast<int*>(n_blended);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // The widths built apart: ops/composite_cuda.py SPECIALISED_WIDTHS.
  switch (a_dim) {
    case 9:  // stage 1: rgb 3 + [normal, depth^2] 4 + depth + 1
      err = launch<9>(num_tiles, s, ts, te, ids, src, gimg, tiles_x, gm, gc,
                      go, ga, nb);
      break;
    case 8:  // stage-2 train (STAGE2_NERF_SYNTHETIC): rgb 3 + pbr 3 + depth + 1
      err = launch<8>(num_tiles, s, ts, te, ids, src, gimg, tiles_x, gm, gc,
                      go, ga, nb);
      break;
    default:
      err = launch<0>(num_tiles, s, ts, te, ids, src, gimg, tiles_x, gm, gc,
                      go, ga, nb);
  }
  return static_cast<int>(err);
}

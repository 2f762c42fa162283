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
//   over all A channels (the constant-1 opacity channel included).
//   Phase B walks again, keeps the inclusive prefix P_i of the same sum,
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
// Design: one block per 16x16 tile, one thread per pixel. Both walks gather
// the tile's depth-sorted ids in batches of 256 into shared memory (mean,
// conic, opacity, g_w, A attributes), and leave a batch early where a warp
// is done and the range once the block is. Phase B sums each pair's 6 + A
// gradient terms across a warp and across warps, and adds them to device
// memory once per (tile, gaussian) with atomicAdd: K2's reduction, from
// composite_grad.cuh (a reduce-scatter per 16 terms, one row per slot,
// touched slots flushed).
//
// What bounds it on the H100: the per-(pixel, pair) arithmetic, twice: an
// expf, ~15 FP32 operations and A FMAs for d in each walk, a division and
// ~30 operations more in phase B, and there the reduction (16 shuffles and
// a warp-wide shared atomic per 16 terms per (warp, pair) with a blended
// pixel, scattered float atomics per (tile, gaussian)). Each walk gathers
// the batch again, 8 + A 4-byte shared loads a pair; the TPU kernel's
// pair-sized data table and per-slot gradient rows are not carried over.
//
// Plain C interface (built by nvcc into a shared library, bound with ctypes):
// r3dg_composite_bwd_two_walk returns the first CUDA error, or 0.

#include <cuda_runtime.h>

#include "composite_grad.cuh"
#include "composite_step.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;  // one thread per pixel; pairs per batch
constexpr int kMaxA = 32;              // widest attribute vector taken
constexpr int kGeom = r3dg::kGeom;
constexpr unsigned kFullMask = r3dg::kFullMask;

// Shared memory, in floats of kBlock each: id, mean x, mean y, conic a, b, c,
// opacity, g_w (8 rows), then A attribute rows; then the gradient
// accumulators, one row of acc_stride floats per slot, and the touched flags.
inline size_t shared_bytes(int a_dim) {
  return static_cast<size_t>(8 + a_dim +
                             r3dg::acc_stride(r3dg::term_chunks(a_dim)) + 1) *
         kBlock * sizeof(float);
}

// d = g_w + sum_a attr_a g_img_a for the pair in slot j, in one fixed order
// with explicit FMAs: both walks compute it bit for bit alike.
template <int AMAX>
__device__ __forceinline__ float pair_dot(const float* s_attr, int j,
                                          const float (&gi)[AMAX], int A,
                                          float gw) {
  float d = gw;
#pragma unroll
  for (int a = 0; a < AMAX; ++a)
    if (a < A) d = __fmaf_rn(s_attr[a * kBlock + j], gi[a], d);
  return d;
}

// A_STATIC > 0: attribute width fixed at compile time; 0: runtime a_dim <= kMaxA.
template <int A_STATIC>
__global__ void __launch_bounds__(kBlock)
composite_bwd_two_walk_kernel(const int* __restrict__ tile_start,
                              const int* __restrict__ tile_end,
                              const int* __restrict__ sorted_ids,
                              const float* __restrict__ mean2d,    // [P, 2]
                              const float* __restrict__ conic,     // [P, 3]
                              const float* __restrict__ opacity,   // [P]
                              const float* __restrict__ attrs,     // [P, A]
                              const float* __restrict__ g_image,   // [tiles, 256, A]
                              const float* __restrict__ g_weights, // [P] or null
                              int tiles_x, int a_dim,
                              float* __restrict__ g_mean2d,        // [P, 2]
                              float* __restrict__ g_conic,         // [P, 3]
                              float* __restrict__ g_opacity,       // [P]
                              float* __restrict__ g_attrs,         // [P, A]
                              int* __restrict__ n_blended) {       // [tiles, 256] or null
  constexpr int AMAX = A_STATIC > 0 ? A_STATIC : kMaxA;
  constexpr int NT = r3dg::kChunk * r3dg::term_chunks(AMAX);
  const int A = A_STATIC > 0 ? A_STATIC : a_dim;
  const int n_chunks = r3dg::term_chunks(A);
  const int stride = r3dg::acc_stride(n_chunks);

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
  float* s_acc = s_attr + A * kBlock;       // [slot][stride]
  int* s_touched = reinterpret_cast<int*>(s_acc + kBlock * stride);

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float px = static_cast<float>((tile % tiles_x) * kTile + tid % kTile);
  const float py = static_cast<float>((tile / tiles_x) * kTile + tid / kTile);
  const int start = tile_start[tile];
  const int end = tile_end[tile];
  const size_t pix = static_cast<size_t>(tile) * kBlock + tid;

  float gi[AMAX];
#pragma unroll
  for (int a = 0; a < AMAX; ++a) gi[a] = a < A ? g_image[pix * A + a] : 0.f;

  // The batch of pairs [base, base + kBlock) ∩ [start, end), gathered by id.
  auto gather = [&](int base) {
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
      s_gw[tid] = g_weights != nullptr ? g_weights[g] : 0.f;
      const float* ag = attrs + static_cast<size_t>(g) * A;
#pragma unroll
      for (int a = 0; a < AMAX; ++a)
        if (a < A) s_attr[a * kBlock + tid] = ag[a];
    }
  };

  // ---- phase A: S_tot = sum over the pixel's blended pairs of w d ---------
  float T = 1.f;
  float s_tot = 0.f;
  int done = 0;
  for (int base = start; base < end; base += kBlock) {
    // Barrier for the previous batch's readers, and the block-wide exit vote.
    if (__syncthreads_count(done) == kBlock) break;
    gather(base);
    __syncthreads();
    const int n = min(kBlock, end - base);
    for (int j = 0; j < n; ++j) {
      if (__all_sync(kFullMask, done)) break;  // warp-uniform: j, n are
      if (!done) {
        const float dx = s_mx[j] - px;
        const float dy = s_my[j] - py;
        const float power = r3dg::pair_power(dx, dy, s_ca[j], s_cb[j], s_cc[j]);
        const float alpha =
            fminf(r3dg::kAlphaMax, __fmul_rn(s_op[j], r3dg::pair_exp(power)));
        if (r3dg::pair_blends(power, alpha)) {
          const float w = __fmul_rn(alpha, T);  // incoming T >= 1e-4 here
          s_tot = __fmaf_rn(w, pair_dot(s_attr, j, gi, A, s_gw[j]), s_tot);
          T = r3dg::transmit(T, alpha);
          done = T < r3dg::kTMin;
        }
      }
    }
  }

  // ---- phase B: the gradients, from the inclusive prefix P_i ---------------
  for (int i = tid; i < kBlock * stride; i += kBlock) s_acc[i] = 0.f;
  s_touched[tid] = 0;
  T = 1.f;
  float prefix = 0.f;
  int count = 0;
  done = 0;
  for (int base = start; base < end; base += kBlock) {
    // Barrier for phase A's and the previous flush's readers; exit vote.
    if (__syncthreads_count(done) == kBlock) break;
    gather(base);
    __syncthreads();
    const int n = min(kBlock, end - base);
    for (int j = 0; j < n; ++j) {
      if (__all_sync(kFullMask, done)) break;  // warp-uniform: j, n are
      float gm[kGeom] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float w = 0.f;
      bool blended = false;
      if (!done) {
        const float dx = s_mx[j] - px;
        const float dy = s_my[j] - py;
        const float ca = s_ca[j], cb = s_cb[j], cc = s_cc[j];
        const float power = r3dg::pair_power(dx, dy, ca, cb, cc);
        const float e = r3dg::pair_exp(power);
        const float raw = __fmul_rn(s_op[j], e);
        const float alpha = fminf(r3dg::kAlphaMax, raw);
        if (r3dg::pair_blends(power, alpha)) {
          blended = true;
          ++count;
          w = __fmul_rn(alpha, T);
          const float d = pair_dot(s_attr, j, gi, A, s_gw[j]);
          prefix = __fmaf_rn(w, d, prefix);
          const float g_alpha = T * d - (s_tot - prefix) / (1.f - alpha);
          const float g_raw = raw < r3dg::kAlphaMax ? g_alpha : 0.f;
          const float g_power = g_raw * raw;
          gm[0] = -g_power * (ca * dx + cb * dy);
          gm[1] = -g_power * (cc * dy + cb * dx);
          gm[2] = g_power * (-0.5f * dx * dx);
          gm[3] = g_power * (-dx * dy);
          gm[4] = g_power * (-0.5f * dy * dy);
          gm[5] = g_raw * e;
          T = r3dg::transmit(T, alpha);
          done = T < r3dg::kTMin;
        }
      }
      float terms[NT];
      r3dg::set_terms(terms, gm, w, gi, A);
      r3dg::reduce_pair(s_acc, stride, s_touched, j, blended, terms, n_chunks,
                        lane);
    }
    __syncthreads();
    if (tid < n)
      r3dg::flush_slot(s_acc, stride, s_touched, tid, s_id[tid], A, g_mean2d,
                       g_conic, g_opacity, g_attrs);
  }
  if (n_blended != nullptr) n_blended[pix] = count;
}

template <int A_STATIC>
cudaError_t launch(int num_tiles, int a_dim, cudaStream_t s, const int* ts,
                   const int* te, const int* ids, const float* m,
                   const float* c, const float* o, const float* at,
                   const float* gimg, const float* gw, int tiles_x, float* gm,
                   float* gc, float* go, float* ga, int* nb) {
  const size_t smem = shared_bytes(a_dim);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_two_walk_kernel<A_STATIC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  composite_bwd_two_walk_kernel<A_STATIC><<<num_tiles, kBlock, smem, s>>>(
      ts, te, ids, m, c, o, at, gimg, gw, tiles_x, a_dim, gm, gc, go, ga, nb);
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
  const auto* m = static_cast<const float*>(mean2d);
  const auto* c = static_cast<const float*>(conic);
  const auto* o = static_cast<const float*>(opacity);
  const auto* at = static_cast<const float*>(attrs);
  const auto* gimg = static_cast<const float*>(g_image);
  const auto* gw = static_cast<const float*>(g_weights);
  auto* gm = static_cast<float*>(g_mean2d);
  auto* gc = static_cast<float*>(g_conic);
  auto* go = static_cast<float*>(g_opacity);
  auto* ga = static_cast<float*>(g_attrs);
  auto* nb = static_cast<int*>(n_blended);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      a_dim == 9  // the stage-1 render: rgb 3 + [normal, depth^2] 4 + depth + 1
          ? launch<9>(num_tiles, a_dim, s, ts, te, ids, m, c, o, at, gimg, gw,
                      tiles_x, gm, gc, go, ga, nb)
          : launch<0>(num_tiles, a_dim, s, ts, te, ids, m, c, o, at, gimg, gw,
                      tiles_x, gm, gc, go, ga, nb);
  return static_cast<int>(err);
}

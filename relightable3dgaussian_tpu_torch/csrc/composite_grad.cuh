// The gradient reduction the backward compositor kernels share: K2
// (composite_bwd.cu) and K5 (composite_bwd_two_walk.cu).
//
// Per pair, each lane holds its pixels' 6 + A gradient terms (d mean x, y;
// d conic a, b, c; d opacity; d attrs), padded with zeros to chunks of 16.
// The warp sums them with composite_warp.cuh's reduce-scatter, one per
// chunk: 8 + 4 + 2 + 1 shuffles and a last exchange put term t's warp sum on
// lanes 2t and 2t + 1, 16 shuffles in 5 steps where a 5-step warp sum per
// term took 5 (6 + A) shuffles in as many steps: 16 against 75 at A = 9. The
// even lanes then add the 16 sums to the pair's accumulator row in one
// warp-wide shared atomic, 16 consecutive words, where lane 0 issued one
// atomic per term. The two-pair reduce_pair sums two pairs in one 32-wide
// reduce-scatter (31 shuffles in 5 steps, one sum on every lane). A warp
// with no blended pixel skips the pair.
//
// The accumulators are one row per slot of the batch, acc_stride floats
// long (odd, so the flush's threads, one slot each, read distinct banks),
// zeroed once when the kernel starts. A warp that adds to a slot marks it
// touched; after the batch, flush_slot adds a touched slot's nonzero sums to
// device memory, one atomicAdd each, once per (tile, gaussian), and zeroes
// them again. Slots that no pixel blended are neither flushed nor zeroed.
#pragma once

#include <cuda_runtime.h>

#include "composite_warp.cuh"

namespace r3dg {

constexpr int kGeom = 6;    // d mean x, y; d conic a, b, c; d opacity
constexpr int kChunk = 16;  // terms per reduce-scatter

// Chunks of 16 that hold 6 + a_dim terms.
__host__ __device__ constexpr int term_chunks(int a_dim) {
  return (kGeom + a_dim + kChunk - 1) / kChunk;
}

// Floats per accumulator row.
__host__ __device__ constexpr int acc_stride(int chunks) {
  return chunks * kChunk + 1;
}

// One pixel's terms: the geometry terms gm, then w * gi[a]; zero past 6 + A.
template <int AMAX, int NT>
__device__ __forceinline__ void set_terms(float (&terms)[NT],
                                          const float (&gm)[kGeom], float w,
                                          const float (&gi)[AMAX], int A) {
#pragma unroll
  for (int t = 0; t < NT; ++t) terms[t] = 0.f;
#pragma unroll
  for (int f = 0; f < kGeom; ++f) terms[f] = gm[f];
#pragma unroll
  for (int a = 0; a < AMAX; ++a)
    if (a < A) terms[kGeom + a] = w * gi[a];
}

// Adds the warp's terms of the pair in slot j to its accumulator row. Every
// lane of the warp calls it (j is warp-uniform); n_chunks (warp-uniform)
// bounds the chunks that hold terms.
template <int NT>
__device__ __forceinline__ void reduce_pair(float* s_acc, int stride,
                                            int* s_touched, int j, bool blended,
                                            const float (&terms)[NT],
                                            int n_chunks, int lane) {
  static_assert(NT % kChunk == 0, "terms come in chunks of 16");
  if (!__any_sync(kFullMask, blended)) return;
  float* row = s_acc + j * stride;
#pragma unroll
  for (int c = 0; c < NT / kChunk; ++c) {
    if (c < n_chunks) {
      float v[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) v[k] = terms[c * kChunk + k];
      const float sum = reduce_scatter(v, lane);
      if ((lane & 1) == 0 && sum != 0.f)
        atomicAdd(&row[c * kChunk + (lane >> 1)], sum);
    }
  }
  if (lane == 0) s_touched[j] = 1;
}

// reduce_pair for two pairs at once, in slots ja and jb (jb < 0: none),
// with one 32-wide reduce-scatter per chunk: lane t holds the sum of pair
// ja's term t (t < 16) or pair jb's term t - 16, so the 5 steps and the
// shared atomic serve both pairs.
template <int NT>
__device__ __forceinline__ void reduce_pair(float* s_acc, int stride,
                                             int* s_touched, int ja,
                                             bool blended_a,
                                             const float (&ta)[NT], int jb,
                                             bool blended_b,
                                             const float (&tb)[NT],
                                             int n_chunks, int lane) {
  static_assert(NT % kChunk == 0, "terms come in chunks of 16");
  const bool any_a = __any_sync(kFullMask, blended_a);
  const bool any_b = __any_sync(kFullMask, blended_b);
  if (!any_a && !any_b) return;
  float* row = s_acc + (lane < kChunk ? ja : max(jb, 0)) * stride;
#pragma unroll
  for (int c = 0; c < NT / kChunk; ++c) {
    if (c < n_chunks) {
      float v[2 * kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        v[k] = ta[c * kChunk + k];
        v[kChunk + k] = tb[c * kChunk + k];
      }
      const float sum = reduce_scatter(v, lane);
      if (sum != 0.f) atomicAdd(&row[c * kChunk + (lane & (kChunk - 1))], sum);
    }
  }
  if (lane == 0 && any_a) s_touched[ja] = 1;
  if (lane == kChunk && any_b) s_touched[jb] = 1;
}

// Adds a touched slot's sums to gaussian g's gradients in device memory and
// zeroes the slot again.
__device__ __forceinline__ void flush_slot(float* s_acc, int stride,
                                           int* s_touched, int slot, int g,
                                           int A, float* g_mean2d,
                                           float* g_conic, float* g_opacity,
                                           float* g_attrs) {
  if (!s_touched[slot]) return;
  s_touched[slot] = 0;
  float* row = s_acc + slot * stride;
  float* ga = g_attrs + static_cast<size_t>(g) * A;
  for (int k = 0; k < kGeom + A; ++k) {
    const float v = row[k];
    if (v == 0.f) continue;
    row[k] = 0.f;
    float* dst = k < 2   ? g_mean2d + 2 * static_cast<size_t>(g) + k
                 : k < 5 ? g_conic + 3 * static_cast<size_t>(g) + (k - 2)
                 : k == 5 ? g_opacity + g
                          : ga + (k - kGeom);
    atomicAdd(dst, v);
  }
}

}  // namespace r3dg

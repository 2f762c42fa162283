// The batch of depth-sorted pairs the compositor kernels K1 (composite_fwd.cu),
// K2 (composite_bwd.cu) and K5 (composite_bwd_two_walk.cu, both of its walks)
// walk, staged in shared memory as packed records.
//
// All run one 128-thread block per 16x16 tile and walk the tile's range of
// gaussian ids in batches of kBatch pairs, one slot staged by each thread.
// A slot is three kinds of float4 row, each kBatch slots long:
//   geo0    = {mean x, mean y, conic a, conic b}
//   geo1    = {conic c, opacity, g_w (the weight cotangent of K2 and K5; 0
//              in K1), gaussian id as float bits}
//   attr[q] = attributes 4q .. 4q + 3, q < ceil(A / 4) (the tail unused),
// so a pixel reads a pair with 2 + ceil(A / 4) broadcast 16-byte shared loads
// where a row per field took 8 + A 4-byte loads. The thread reads the pair's
// id with a plain load one batch ahead and copies the gaussian's fields into
// its slot with cp.async: no registers wait on the gather, and two buffers
// alternate, so the next batch lands while the block walks the current one.
// The caller commits each batch's copies as one group, waits for all but the
// newest group, and then __syncthreads() before it reads the batch.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace r3dg {

constexpr int kBatch = 128;  // pairs per batch; one slot staged per thread

__host__ __device__ constexpr int attr_quads(int a_dim) { return (a_dim + 3) / 4; }

// float4s of one batch buffer: geo0, geo1 and the attribute rows.
__host__ __device__ constexpr int batch_float4s(int a_dim) {
  return (2 + attr_quads(a_dim)) * kBatch;
}

// Where a batch's per-gaussian fields come from. mean_8b: mean2d is 8-byte
// aligned (copied as float2); attr_16b: A % 4 == 0 and attrs 16-byte aligned
// (copied as float4s). g_weights may be null (zeros).
struct BatchSource {
  const float* mean2d;     // [P, 2]
  const float* conic;      // [P, 3]
  const float* opacity;    // [P]
  const float* g_weights;  // [P] or null
  const float* attrs;      // [P, A]
  int a_dim;
  bool mean_8b;
  bool attr_16b;
};

// Issues the copies of gaussian g's record into slot `slot` of `buf`.
template <int A_STATIC>
__device__ __forceinline__ void stage_record(float4* buf, int slot, int g,
                                             const BatchSource& src) {
  constexpr int AMAX = A_STATIC > 0 ? A_STATIC : 32;
  const int A = A_STATIC > 0 ? A_STATIC : src.a_dim;
  float* geo0 = reinterpret_cast<float*>(buf + slot);
  float* geo1 = reinterpret_cast<float*>(buf + kBatch + slot);
  const float* m = src.mean2d + 2 * static_cast<size_t>(g);
  if (src.mean_8b) {
    cp_async<8>(geo0, m);
  } else {
    cp_async<4>(geo0, m);
    cp_async<4>(geo0 + 1, m + 1);
  }
  const float* c = src.conic + 3 * static_cast<size_t>(g);
  cp_async<4>(geo0 + 2, c);
  cp_async<4>(geo0 + 3, c + 1);
  cp_async<4>(geo1, c + 2);
  cp_async<4>(geo1 + 1, src.opacity + g);
  if (src.g_weights != nullptr) {
    cp_async<4>(geo1 + 2, src.g_weights + g);
  } else {
    geo1[2] = 0.f;
  }
  geo1[3] = __int_as_float(g);
  const float* ag = src.attrs + static_cast<size_t>(g) * A;
  float4* at = buf + 2 * kBatch + slot;
  if (src.attr_16b) {
#pragma unroll
    for (int q = 0; q < attr_quads(AMAX); ++q)
      if (4 * q < A) cp_async<16>(at + q * kBatch, ag + 4 * q);
  } else {
#pragma unroll
    for (int a = 0; a < AMAX; ++a)
      if (a < A)
        cp_async<4>(reinterpret_cast<float*>(at + (a >> 2) * kBatch) + (a & 3),
                    ag + a);
  }
}

// Reads slot j's attributes into at[0 .. 4 * ceil(A / 4)).
template <int AMAX>
__device__ __forceinline__ void load_attrs(const float4* buf, int j, int A,
                                           float (&at)[4 * attr_quads(AMAX)]) {
#pragma unroll
  for (int q = 0; q < attr_quads(AMAX); ++q) {
    if (4 * q < A) {
      const float4 v = buf[(2 + q) * kBatch + j];
      at[4 * q] = v.x;
      at[4 * q + 1] = v.y;
      at[4 * q + 2] = v.z;
      at[4 * q + 3] = v.w;
    }
  }
}

}  // namespace r3dg

// The warp-wide reduce-scatter the compositor kernels sum with: K1's
// per-gaussian weights (composite_fwd.cu) and K2's and K5's gradient terms
// (composite_grad.cuh). K4 (shading.cu) takes two of its butterfly steps to
// sum over a group of 4 lanes.
//
// Each lane holds N values (N a power of two, at most 32). Each butterfly
// step sends half of the values a lane still holds to its partner and adds
// the half it gets back: N/2 + N/4 + ... + 1 shuffles, then one plain
// exchange for each lane bit left. At the end value t's warp sum is on the
// 32 / N lanes t (32 / N), ... , t (32 / N) + 32 / N - 1. A warp sum per value
// would take 5 N shuffles, each step waiting on the one before; here the
// shuffles of one step are independent and there are only 5 steps.
#pragma once

#include <cuda_runtime.h>

namespace r3dg {

constexpr unsigned kFullMask = 0xffffffffu;

// One butterfly step over v[0, 2 HALF): keep the half that the lane's bit
// OFF selects, add the partner's copy of it.
template <int HALF, int OFF, int N>
__device__ __forceinline__ void scatter_step(float (&v)[N], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = upper ? v[k] : v[k + HALF];
    const float keep = upper ? v[k + HALF] : v[k];
    v[k] = keep + __shfl_xor_sync(kFullMask, send, OFF);
  }
}

// The warp sum of v[lane / (32 / N)] (v is consumed).
template <int N, int HALF = N / 2, int OFF = 16>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N: 1, 2, 4 .. 32");
  if constexpr (HALF >= 1) {
    scatter_step<HALF, OFF>(v, lane);
    return reduce_scatter<N, HALF / 2, OFF / 2>(v, lane);
  } else if constexpr (OFF >= 1) {
    v[0] += __shfl_xor_sync(kFullMask, v[0], OFF);
    return reduce_scatter<N, 0, OFF / 2>(v, lane);
  } else {
    return v[0];
  }
}

}  // namespace r3dg

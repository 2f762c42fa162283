// The env light's lookup, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the lookup to XLA (models/
// lights.py there: bilinear grid_sample arithmetic, with a one-hot matmul
// for small maps). The port's plain version is models/lights.py::
// equirect_query_plain (F.grid_sample, bilinear, align_corners, zero
// padding), which CPU tensors take. Per direction d [3] (and the optional
// 3x3 light transform T):
//   d'    = T d
//   phi   = acos(clip(d'z, -1, 1)) - 1e-6,  theta = atan2(d'y, d'x)
//   gy    = 2 phi / pi - 1,  gx = -theta / pi
//   ix    = ((gx + 1) / 2) (W - 1),  iy = ((gy + 1) / 2) (H - 1)
//   out_c = sum over the four taps (floor(ix) + {0, 1}, floor(iy) + {0, 1})
//           of weight * map[y, x, c], a tap outside the map adding nothing,
// as grid_sample computes it (its corner order nw, ne, sw, se). The
// backward gives the map's gradient alone: grad[y, x, c] = sum over the
// directions of weight * g_out[c]; it recomputes taps and weights from the
// directions, so nothing but the directions (the visibility cache's tensor)
// is kept for it. Directions and a transform that need a gradient are
// refused by the wrapper (ops/env_lookup_cuda.py).
//
// What bounds it on the H100. Both kernels are bound by bytes: the forward
// reads 12 bytes of direction and writes 12 of radiance a sample, the
// backward reads 12 of direction and 12 of upstream gradient; at s2-train's
// 300,000 x 64 samples that is 460.8 MB each way, 0.138 ms at 3.35 TB/s.
// Some 60 FP32 operations a sample (acosf, atan2f, the weights, 12 FMAs)
// take 0.017 ms at 67 TFLOP/s.
//
// Design. The forward is one sample a thread, grid-stride, the map read
// through the read-only path (a 16 x 32 map is 6 KB in L1; a 512 x 1024
// one 6.3 MB in L2), the output written contiguous [N, 3].
// The backward's difficulty is contention: s2-train scatters 19.2M samples
// x 4 taps x 3 channels into a 16 x 32 x 3 map, 1,536 addresses, which
// cuDNN's atomics serialise (12.5 ms). Here each warp owns a private copy of
// the map's gradient in shared memory (kWarps copies a block: 48 KB at
// 16 x 32), so no two warps ever touch one address. Inside a warp, lanes
// whose taps share their first texel (floor(ix), floor(iy)) are found with
// one __match_any_sync and add in lane order, one round per rank, a tap at a
// time (a round's lanes then write distinct addresses for each tap), so a
// copy takes its sums in an order fixed by the samples alone. Matching the
// first texel once, not each tap, took the kernel from 0.774 to 0.332 ms at
// s2-train's shape on an H100 80GB HBM3 at 700 W (cuDNN: 13.8 ms); warp
// copies with shared-memory atomics, in no fixed order, took 0.708 ms. The
// block then sums its warps' copies in warp order into its row of a
// [blocks, H W 3] partial, and env_bilinear_sampler_bw_reduce_kernel sums
// the rows in a fixed block order. The
// grid depends on the sample count and the card's SM count only, so the
// gradient is bitwise the same from run to run, which cuDNN's atomics are
// not. The private branch runs where kWarps copies fit kPrivateBytes
// (192 KB of the 227 KB a block may hold: H W <= 2048 texels, the 16 x 32
// map and one upsample of it); a larger map takes the same kernel's global
// branch, an atomicAdd a tap and channel into the gradient, whose addresses
// are then many enough that contention is low (not bitwise reproducible).
//
// Why not fold the lookup into K4 (csrc/shading.cu): it would save only the
// [P, S, 3] light's write and read, ~0.3 ms a step, and reopen K4's float64
// clip fix-up; the backward's contention, the cost, stays either way.
//
// Precision: float32 loads, arithmetic and sums; IEEE divides, acosf and
// atan2f; no fast-math flags.
//
// Plain C interface (built by nvcc into a shared library, bound with ctypes):
// r3dg_env_lookup_fwd and r3dg_env_lookup_bwd return the first CUDA error,
// or 0.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPrivateBytes = 192 * 1024;   // ops/env_lookup_cuda.py
constexpr int kReduceWarps = 8;
constexpr float kPi = 3.14159265358979323846f;

// The four taps of one direction: texel indices y W + x (-1 outside the
// map) and weights, in grid_sample's order nw, ne, sw, se, and a key of the
// first tap's texel unique over y0 in [-1, H), x0 in [-1, W] (it may lie
// outside the map).
struct Taps {
  int idx[4];
  float w[4];
  int key;
};

__device__ __forceinline__ Taps taps_of(const float* __restrict__ dirs,
                                        const float* t, bool transformed,
                                        int64_t i, int H, int W) {
  float x = __ldg(dirs + 3 * i), y = __ldg(dirs + 3 * i + 1),
        z = __ldg(dirs + 3 * i + 2);
  if (transformed) {                // d @ T^T
    const float tx = t[0] * x + t[1] * y + t[2] * z;
    const float ty = t[3] * x + t[4] * y + t[5] * z;
    const float tz = t[6] * x + t[7] * y + t[8] * z;
    x = tx; y = ty; z = tz;
  }
  const float phi = acosf(fminf(fmaxf(z, -1.f), 1.f)) - 1e-6f;
  const float theta = atan2f(y, x);
  const float gy = (phi / kPi) * 2.f - 1.f;
  const float gx = -theta / kPi;
  const float ix = ((gx + 1.f) / 2.f) * static_cast<float>(W - 1);
  const float iy = ((gy + 1.f) / 2.f) * static_cast<float>(H - 1);
  const float fx = floorf(ix), fy = floorf(iy);
  const int x0 = static_cast<int>(fx), y0 = static_cast<int>(fy);
  const float wx1 = ix - fx, wx0 = (fx + 1.f) - ix;
  const float wy1 = iy - fy, wy0 = (fy + 1.f) - iy;
  Taps tp;
  tp.key = (y0 + 1) * (W + 2) + (x0 + 1);
  tp.w[0] = wx0 * wy0; tp.w[1] = wx1 * wy0;
  tp.w[2] = wx0 * wy1; tp.w[3] = wx1 * wy1;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int xi = x0 + (c & 1), yi = y0 + (c >> 1);
    tp.idx[c] = (xi >= 0 && xi < W && yi >= 0 && yi < H) ? yi * W + xi : -1;
  }
  return tp;
}

__device__ __forceinline__ bool load_transform(const float* __restrict__ tf,
                                               float* t) {
  if (tf == nullptr) return false;
#pragma unroll
  for (int k = 0; k < 9; ++k) t[k] = __ldg(tf + k);
  return true;
}

__global__ void __launch_bounds__(kThreads)
env_lookup_fwd_kernel(const float* __restrict__ env,
                      const float* __restrict__ dirs,
                      const float* __restrict__ tf, int64_t n, int H, int W,
                      float* __restrict__ out) {
  float t[9];
  const bool transformed = load_transform(tf, t);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const Taps tp = taps_of(dirs, t, transformed, i, H, W);
    float o0 = 0.f, o1 = 0.f, o2 = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (tp.idx[c] >= 0) {
        const float* v = env + 3 * static_cast<int64_t>(tp.idx[c]);
        o0 += __ldg(v) * tp.w[c];
        o1 += __ldg(v + 1) * tp.w[c];
        o2 += __ldg(v + 2) * tp.w[c];
      }
    }
    out[3 * i] = o0;
    out[3 * i + 1] = o1;
    out[3 * i + 2] = o2;
  }
}

// The map's gradient. A warp takes 32 consecutive samples at a time, grid-
// stride over warps. Private branch (`partial` a [gridDim.x, H W 3] array):
// each warp adds into its own shared copy, lanes of one first texel in lane
// order, then the block writes the sum of its copies, in warp order, to its
// row.
// Global branch (`partial` null): atomicAdd into `grad`, zeroed by the
// caller.
__global__ void __launch_bounds__(kThreads)
env_bilinear_sampler_bw_kernel(const float* __restrict__ dirs,
                               const float* __restrict__ tf,
                               const float* __restrict__ g_out, int64_t n,
                               int H, int W, float* __restrict__ partial,
                               float* __restrict__ grad) {
  extern __shared__ float copies[];          // [kWarps, H W 3], private only
  const int hw3 = 3 * H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool priv = partial != nullptr;
  float* mine = copies + warp * hw3;
  if (priv) {
    for (int j = threadIdx.x; j < kWarps * hw3; j += kThreads) copies[j] = 0.f;
    __syncthreads();
  }
  float t[9];
  const bool transformed = load_transform(tf, t);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads + 32 * warp;
       base < n; base += stride) {       // warp-uniform: every lane iterates
    const int64_t i = base + lane;
    Taps tp;
    float g0 = 0.f, g1 = 0.f, g2 = 0.f;
    if (i < n) {
      tp = taps_of(dirs, t, transformed, i, H, W);
      g0 = __ldg(g_out + 3 * i);
      g1 = __ldg(g_out + 3 * i + 1);
      g2 = __ldg(g_out + 3 * i + 2);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) { tp.idx[c] = -1; tp.w[c] = 0.f; }
    }
    if (priv) {
      // A lane past the samples is a group of its own (a negative key).
      const unsigned peers =
          __match_any_sync(0xffffffffu, i < n ? tp.key : -1 - lane);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      const int rounds = __reduce_max_sync(0xffffffffu, rank) + 1;
      for (int r = 0; r < rounds; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (rank == r && tp.idx[c] >= 0) {
            float* v = mine + 3 * tp.idx[c];
            v[0] += tp.w[c] * g0;
            v[1] += tp.w[c] * g1;
            v[2] += tp.w[c] * g2;
          }
          __syncwarp();
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (tp.idx[c] >= 0) {
          atomicAdd(grad + 3 * tp.idx[c], tp.w[c] * g0);
          atomicAdd(grad + 3 * tp.idx[c] + 1, tp.w[c] * g1);
          atomicAdd(grad + 3 * tp.idx[c] + 2, tp.w[c] * g2);
        }
      }
    }
  }
  if (priv) {
    __syncthreads();
    float* row = partial + static_cast<int64_t>(blockIdx.x) * hw3;
    for (int j = threadIdx.x; j < hw3; j += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) s += copies[k * hw3 + j];
      row[j] = s;
    }
  }
}

// grad[j] = the sum over b of partial[b, j] in a fixed order: warp k of a
// block sums the rows of its contiguous share of b in order, then the
// shares are added in warp order. 32 columns a block.
__global__ void __launch_bounds__(32 * kReduceWarps)
env_bilinear_sampler_bw_reduce_kernel(const float* __restrict__ partial,
                                      int blocks, int hw3,
                                      float* __restrict__ grad) {
  __shared__ float sums[kReduceWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  const int per = (blocks + kReduceWarps - 1) / kReduceWarps;
  const int b0 = warp * per;
  const int b1 = b0 + per < blocks ? b0 + per : blocks;
  float s = 0.f;
  if (j < hw3)
    for (int b = b0; b < b1; ++b)
      s += __ldg(partial + static_cast<int64_t>(b) * hw3 + j);
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < hw3) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kReduceWarps; ++k) total += sums[k][lane];
    grad[j] = total;
  }
}

}  // namespace

// out [n, 3] = the lookup of dirs [n, 3] (through tf [3, 3] when not null)
// in env [H, W, 3]; `blocks` of kThreads threads, grid-stride.
extern "C" int r3dg_env_lookup_fwd(const void* env, const void* dirs,
                                   const void* tf, int64_t n, int H, int W,
                                   int blocks, void* out, void* stream) {
  if (n <= 0) return 0;
  if (H < 1 || W < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  env_lookup_fwd_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(env), static_cast<const float*>(dirs),
      static_cast<const float*>(tf), n, H, W, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// grad [H, W, 3] = the map's gradient for upstream g_out [n, 3]. With
// `partial` ([blocks, H W 3] scratch) the private branch and the reduce;
// without, the global branch into `grad`, which must be zero.
extern "C" int r3dg_env_lookup_bwd(const void* dirs, const void* tf,
                                   const void* g_out, int64_t n, int H, int W,
                                   int blocks, void* partial, void* grad,
                                   void* stream) {
  if (H < 1 || W < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hw3 = 3 * H * W;
  const size_t smem = partial ? sizeof(float) * kWarps * hw3 : 0;
  if (smem > static_cast<size_t>(kPrivateBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        env_bilinear_sampler_bw_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  env_bilinear_sampler_bw_kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(tf),
      static_cast<const float*>(g_out), n, H, W,
      static_cast<float*>(partial), static_cast<float*>(grad));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return static_cast<int>(err);
  env_bilinear_sampler_bw_reduce_kernel<<<(hw3 + 31) / 32, 32 * kReduceWarps,
                                          0, s>>>(
      static_cast<const float*>(partial), blocks, hw3,
      static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}

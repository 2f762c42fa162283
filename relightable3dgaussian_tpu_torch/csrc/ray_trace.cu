// Kernel K3: ray-traced transmittance through the gaussian cloud, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel relightable3dgaussian_tpu/ops/ray_trace.py::
// _trace_eval_kernel (launched by _eval_blocks_pallas from _trace_sorted_jit).
// Per ray (origin o already offset by 0.05 d, unit direction d), T = prod
// (1 - alpha) over every gaussian of each cluster whose AABB the ray slab-hits
// (t_max > 0), with the whitened per-gaussian test of ops/ray_trace.py:
//   u = W (g - o), v = W d, W = diag(1/s) R^T;  t = u.v / max(v.v, 1e-12);
//   power = -0.5 |u - t v|^2;  tested when op >= 1/255, n.d <= 0, t >= 0.01;
//   alpha = min(op e^power, 0.9999).
// g - o is taken first, then W, in float32. The pair test's arithmetic is
// written with __fmul_rn/__fadd_rn in the plain version's order, so no FMA
// contraction moves a t >= 0.01 or n.d <= 0 decision away from it; expf, no
// fast math. A ray stops once T < 0.9: its visibility is 0 whatever else it
// passes. The wrapper applies the T >= 0.9 rule.
//
// Design: one thread per ray. The BVH is gaussians in Morton order, grouped in
// clusters of 32 (one record of 16 floats per gaussian, four float4 loads:
// g, W row-major, opacity, normal), with an AABB per cluster and per group of
// 32 clusters ("super"). Super AABBs are staged block-wide in shared memory; a
// ray walks the supers it hits, the clusters it hits in each, and tests all 32
// records of each hit cluster. The caller lays rays out by point in Morton
// order, so a warp holds the samples of neighbouring points and walks similar
// clusters.
//
// What bounds it on the H100: divergence (rays of a warp hit different
// clusters and stop at different times) and L2 reads of the 64-byte gaussian
// records, re-read by every ray that hits their cluster. The TPU kernel's
// block-wide candidate selection, quad feature tiles and bf16x3 matmul are not
// carried over.
//
// Plain C interface (built by nvcc into a shared library, bound with ctypes):
// r3dg_trace returns the first CUDA error, or 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCluster = 32;     // gaussians per cluster
constexpr int kSuper = 32;       // clusters per super
constexpr int kSupChunk = 256;   // supers staged in shared memory at a time
constexpr float kTMin = 0.9f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float safe_inverse(float d) {
  const float tiny = d >= 0.f ? 1e-12f : -1e-12f;
  return 1.f / (fabsf(d) < 1e-12f ? tiny : d);
}

// The ray's t > 0 part meets the box [lo, hi], and the box is not empty.
__device__ __forceinline__ bool slab_hit(const float* lo, const float* hi,
                                         const Ray& r) {
  float t0 = (lo[0] - r.ox) * r.ix, t1 = (hi[0] - r.ox) * r.ix;
  float tmin = fminf(t0, t1), tmax = fmaxf(t0, t1);
  t0 = (lo[1] - r.oy) * r.iy; t1 = (hi[1] - r.oy) * r.iy;
  tmin = fmaxf(tmin, fminf(t0, t1)); tmax = fminf(tmax, fmaxf(t0, t1));
  t0 = (lo[2] - r.oz) * r.iz; t1 = (hi[2] - r.oz) * r.iz;
  tmin = fmaxf(tmin, fminf(t0, t1)); tmax = fminf(tmax, fmaxf(t0, t1));
  return tmax > 0.f && tmax >= tmin && lo[0] <= hi[0] && lo[1] <= hi[1] &&
         lo[2] <= hi[2];
}

// a0 b0 + a1 b1 + a2 b2, left to right, unfused.
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// 1 - alpha of one (ray, gaussian) pair, 1 where the pair is not tested.
__device__ __forceinline__ float one_minus_alpha(const float4* __restrict__ rec,
                                                 const Ray& r) {
  const float4 e = __ldg(rec + 3);  // op, n
  const float op = e.x;
  const float nd = dot3(e.y, e.z, e.w, r.dx, r.dy, r.dz);
  if (!(op >= 1.f / 255.f) || !(nd <= 0.f)) return 1.f;
  const float4 a = __ldg(rec);      // g, W00
  const float4 b = __ldg(rec + 1);  // W01 W02 W10 W11
  const float4 c = __ldg(rec + 2);  // W12 W20 W21 W22
  const float gx = __fsub_rn(a.x, r.ox), gy = __fsub_rn(a.y, r.oy),
              gz = __fsub_rn(a.z, r.oz);
  const float u0 = dot3(a.w, b.x, b.y, gx, gy, gz);
  const float u1 = dot3(b.z, b.w, c.x, gx, gy, gz);
  const float u2 = dot3(c.y, c.z, c.w, gx, gy, gz);
  const float v0 = dot3(a.w, b.x, b.y, r.dx, r.dy, r.dz);
  const float v1 = dot3(b.z, b.w, c.x, r.dx, r.dy, r.dz);
  const float v2 = dot3(c.y, c.z, c.w, r.dx, r.dy, r.dz);
  const float vv = fmaxf(dot3(v0, v1, v2, v0, v1, v2), 1e-12f);
  const float t = __fdiv_rn(dot3(u0, u1, u2, v0, v1, v2), vv);
  if (!(t >= 0.01f)) return 1.f;
  const float r0 = __fsub_rn(u0, __fmul_rn(t, v0));
  const float r1 = __fsub_rn(u1, __fmul_rn(t, v1));
  const float r2 = __fsub_rn(u2, __fmul_rn(t, v2));
  const float power = __fmul_rn(-0.5f, dot3(r0, r1, r2, r0, r1, r2));
  const float alpha = fminf(__fmul_rn(op, expf(power)), 0.9999f);
  return __fsub_rn(1.f, alpha);
}

__global__ void __launch_bounds__(kThreads)
trace_kernel(const float4* __restrict__ records,   // [C * 32 * 4]
             const float* __restrict__ cluster_lo, // [C, 3]
             const float* __restrict__ cluster_hi, // [C, 3]
             const float* __restrict__ super_lo,   // [NS, 3]
             const float* __restrict__ super_hi,   // [NS, 3]
             int n_clusters, int n_supers,
             const float* __restrict__ rays_o,     // [R, 3]
             const float* __restrict__ rays_d,     // [R, 3]
             int n_rays, float* __restrict__ T_out) {
  __shared__ float s_lo[kSupChunk * 3];
  __shared__ float s_hi[kSupChunk * 3];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_rays;
  Ray r{};
  if (live) {
    r.ox = rays_o[3 * i]; r.oy = rays_o[3 * i + 1]; r.oz = rays_o[3 * i + 2];
    r.dx = rays_d[3 * i]; r.dy = rays_d[3 * i + 1]; r.dz = rays_d[3 * i + 2];
    r.ix = safe_inverse(r.dx); r.iy = safe_inverse(r.dy);
    r.iz = safe_inverse(r.dz);
  }
  float T = 1.f;
  for (int s0 = 0; s0 < n_supers; s0 += kSupChunk) {
    const int n = min(kSupChunk, n_supers - s0);
    __syncthreads();  // the previous chunk is read
    for (int k = threadIdx.x; k < 3 * n; k += kThreads) {
      s_lo[k] = super_lo[3 * s0 + k];
      s_hi[k] = super_hi[3 * s0 + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int s = 0; s < n && T >= kTMin; ++s) {
      if (!slab_hit(s_lo + 3 * s, s_hi + 3 * s, r)) continue;
      const int c0 = (s0 + s) * kSuper;
      const int c1 = min(c0 + kSuper, n_clusters);
      for (int c = c0; c < c1 && T >= kTMin; ++c) {
        if (!slab_hit(cluster_lo + 3 * c, cluster_hi + 3 * c, r)) continue;
        const float4* rec = records + static_cast<size_t>(c) * kCluster * 4;
        for (int g = 0; g < kCluster; ++g) T *= one_minus_alpha(rec + 4 * g, r);
      }
    }
  }
  if (live) T_out[i] = T;
}

}  // namespace

extern "C" int r3dg_trace(const void* records, const void* cluster_lo,
                          const void* cluster_hi, const void* super_lo,
                          const void* super_hi, const void* rays_o,
                          const void* rays_d, int n_clusters, int n_supers,
                          int n_rays, void* T_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  trace_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(records),
      static_cast<const float*>(cluster_lo),
      static_cast<const float*>(cluster_hi),
      static_cast<const float*>(super_lo), static_cast<const float*>(super_hi),
      n_clusters, n_supers, static_cast<const float*>(rays_o),
      static_cast<const float*>(rays_d), n_rays, static_cast<float*>(T_out));
  return static_cast<int>(cudaGetLastError());
}

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
// fast math. A ray stops once T < 0.9 after a cluster: its visibility is 0
// whatever else it passes. The wrapper applies the T >= 0.9 rule.
//
// The BVH is gaussians in Morton order, grouped in clusters of 32 (one record
// of 16 floats per gaussian: g, W row-major, opacity, normal), with an AABB
// per cluster and per group of 32 clusters ("super").
//
// What bounded it on the H100 (the first design, one thread per ray walking
// its own hit clusters and reading each record from L2): the rays of a warp
// hit different clusters, so the warp ran the union of its lanes' clusters with
// most lanes idle, and every lane re-read the 64-byte records of its own
// clusters. The caller laid rays out by point, so a warp's 32 rays were one
// point's directions fanned over a hemisphere: the least coherent bundle.
//
// Design. The wrapper (ops/ray_trace_cuda.py::trace_k3) hands the rays in
// coherent order (ops/ray_trace.py::coherent_order: octahedral direction bin
// major, origin Morton cell minor), as an index array the kernel reads
// through, so a warp holds 32 near-parallel rays from nearby origins. A warp
// traverses together: each lane slab-tests its ray against the super and
// then each cluster box in order (boxes read at warp-uniform addresses), and
// __ballot_sync gives the lanes that hit. For a hit cluster each lane loads
// one of its 32 records into registers (the warp reads the cluster's 2 KB
// once), and the warp takes the hitting rays one by one: lane l tests record
// l against that ray (read from shared memory by broadcast), and a 5-step
// butterfly multiplies the 32 factors. So the pair tests run on all 32 lanes
// whatever the number of lanes that hit, and no lane re-reads a record. The
// ray's T is then multiplied by its cluster's product. The warp leaves when
// every lane has T < 0.9 or no ray left.
//
// Per-ray result. A ray's T is the product over its hit clusters in cluster
// order of each cluster's butterfly product, a fixed tree over the records'
// indices; every factor is computed by the same code from the ray and the
// record alone. So T is bitwise the same whatever the other rays of the warp
// and the order of the rays (tests/test_torch_cuda.py pins it).
//
// What bounds it now: the pair tests' FP32 issue (about 100 instructions a
// (ray, hit cluster) for each lane, of which the n.d test idles the lanes
// whose gaussian faces away), and the slab tests of the clusters of each
// hit super (about 25 instructions a cluster for the warp).
//
// Plain C interface (built by nvcc into a shared library, bound with ctypes):
// r3dg_trace returns the first CUDA error, or 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;    // 4 warps; each traces its own 32 rays
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 32;     // gaussians per cluster: one per lane
constexpr int kSuper = 32;       // clusters per super
constexpr float kTMin = 0.9f;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kCluster == 32, "a cluster's records are one per lane");

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float safe_inverse(float d) {
  const float tiny = d >= 0.f ? 1e-12f : -1e-12f;
  return 1.f / (fabsf(d) < 1e-12f ? tiny : d);
}

// The ray's t > 0 part meets the box [lo, hi], and the box is not empty.
__device__ __forceinline__ bool slab_hit(const float* __restrict__ lo,
                                         const float* __restrict__ hi,
                                         const Ray& r) {
  const float l0 = __ldg(lo), l1 = __ldg(lo + 1), l2 = __ldg(lo + 2);
  const float h0 = __ldg(hi), h1 = __ldg(hi + 1), h2 = __ldg(hi + 2);
  float t0 = (l0 - r.ox) * r.ix, t1 = (h0 - r.ox) * r.ix;
  float tmin = fminf(t0, t1), tmax = fmaxf(t0, t1);
  t0 = (l1 - r.oy) * r.iy; t1 = (h1 - r.oy) * r.iy;
  tmin = fmaxf(tmin, fminf(t0, t1)); tmax = fminf(tmax, fmaxf(t0, t1));
  t0 = (l2 - r.oz) * r.iz; t1 = (h2 - r.oz) * r.iz;
  tmin = fmaxf(tmin, fminf(t0, t1)); tmax = fminf(tmax, fmaxf(t0, t1));
  return tmax > 0.f && tmax >= tmin && l0 <= h0 && l1 <= h1 && l2 <= h2;
}

// a0 b0 + a1 b1 + a2 b2, left to right, unfused.
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// 1 - alpha of one (ray, gaussian) pair, 1 where the pair is not tested.
// The record: a = {g, W00}, b = {W01 W02 W10 W11}, c = {W12 W20 W21 W22},
// e = {op, n}; the ray: origin (ox, oy, oz), direction (dx, dy, dz).
__device__ __forceinline__ float one_minus_alpha(const float4& a,
                                                 const float4& b,
                                                 const float4& c,
                                                 const float4& e, float ox,
                                                 float oy, float oz, float dx,
                                                 float dy, float dz) {
  const float op = e.x;
  const float nd = dot3(e.y, e.z, e.w, dx, dy, dz);
  if (!(op >= 1.f / 255.f) || !(nd <= 0.f)) return 1.f;
  const float gx = __fsub_rn(a.x, ox), gy = __fsub_rn(a.y, oy),
              gz = __fsub_rn(a.z, oz);
  const float u0 = dot3(a.w, b.x, b.y, gx, gy, gz);
  const float u1 = dot3(b.z, b.w, c.x, gx, gy, gz);
  const float u2 = dot3(c.y, c.z, c.w, gx, gy, gz);
  const float v0 = dot3(a.w, b.x, b.y, dx, dy, dz);
  const float v1 = dot3(b.z, b.w, c.x, dx, dy, dz);
  const float v2 = dot3(c.y, c.z, c.w, dx, dy, dz);
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
             const int* __restrict__ order,        // [R] or null (identity)
             int n_rays, float* __restrict__ T_out) {
  // each warp's rays, read by broadcast: {ox, oy, oz, dx}, {dy, dz, -, -}
  __shared__ float4 s_ray[kWarps][2][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * kThreads + threadIdx.x;
  const bool live = slot < n_rays;
  const int ray = !live ? 0 : order != nullptr ? order[slot] : slot;
  Ray r{};
  if (live) {
    r.ox = rays_o[3 * ray]; r.oy = rays_o[3 * ray + 1];
    r.oz = rays_o[3 * ray + 2];
    r.dx = rays_d[3 * ray]; r.dy = rays_d[3 * ray + 1];
    r.dz = rays_d[3 * ray + 2];
    r.ix = safe_inverse(r.dx); r.iy = safe_inverse(r.dy);
    r.iz = safe_inverse(r.dz);
  }
  s_ray[warp][0][lane] = make_float4(r.ox, r.oy, r.oz, r.dx);
  s_ray[warp][1][lane] = make_float4(r.dy, r.dz, 0.f, 0.f);
  __syncwarp();

  float T = 1.f;
  bool done = !live;
  for (int s = 0; s < n_supers; ++s) {
    if (__all_sync(kFullMask, done)) break;
    const bool hit_super =
        !done && slab_hit(super_lo + 3 * s, super_hi + 3 * s, r);
    if (!__any_sync(kFullMask, hit_super)) continue;
    const int c1 = min((s + 1) * kSuper, n_clusters);
    for (int c = s * kSuper; c < c1; ++c) {
      const bool hit = hit_super && !done &&
                       slab_hit(cluster_lo + 3 * c, cluster_hi + 3 * c, r);
      unsigned hits = __ballot_sync(kFullMask, hit);
      if (hits == 0u) continue;
      // this lane's record of the cluster
      const float4* rec =
          records + (static_cast<size_t>(c) * kCluster + lane) * 4;
      const float4 ra = __ldg(rec), rb = __ldg(rec + 1), rc = __ldg(rec + 2),
                   re = __ldg(rec + 3);
      while (hits != 0u) {  // warp-uniform
        const int src = __ffs(hits) - 1;
        hits &= hits - 1;
        const float4 q0 = s_ray[warp][0][src], q1 = s_ray[warp][1][src];
        float f = one_minus_alpha(ra, rb, rc, re, q0.x, q0.y, q0.z, q0.w,
                                  q1.x, q1.y);
        if (__all_sync(kFullMask, f == 1.f)) continue;  // T * 1 = T
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          f = __fmul_rn(f, __shfl_xor_sync(kFullMask, f, off));
        if (lane == src) T = __fmul_rn(T, f);
      }
      done = done || (hit && T < kTMin);
    }
  }
  if (live) T_out[ray] = T;
}

}  // namespace

extern "C" int r3dg_trace(const void* records, const void* cluster_lo,
                          const void* cluster_hi, const void* super_lo,
                          const void* super_hi, const void* rays_o,
                          const void* rays_d, const void* order,
                          int n_clusters, int n_supers, int n_rays,
                          void* T_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  trace_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(records),
      static_cast<const float*>(cluster_lo),
      static_cast<const float*>(cluster_hi),
      static_cast<const float*>(super_lo), static_cast<const float*>(super_hi),
      n_clusters, n_supers, static_cast<const float*>(rays_o),
      static_cast<const float*>(rays_d), static_cast<const int*>(order),
      n_rays, static_cast<float*>(T_out));
  return static_cast<int>(cudaGetLastError());
}

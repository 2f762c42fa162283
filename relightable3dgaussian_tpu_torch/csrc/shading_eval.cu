// Kernel K6: the stage-2 eval shading, fused, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this function to XLA's
// fusion (relightable3dgaussian_tpu/models/render_neilf.py::
// _shade_chunk_reduced). The port's plain version is ops/shading.py::
// rendering_equation over chunks of points with the env query
// models/lights.py::equirect_query, its per-sample lights kept only as their
// means over the samples (ops/shading_eval_cuda.py::
// rendering_equation_eval_reference). Per point, over its S incident samples
// (dir d, visibility, area):
//   d'      = T d                      (the optional 3x3 light transform)
//   env_c   = grid_sample(map, gx = -atan2(d'y, d'x) / pi,
//                         gy = 2 (acos(clip d'z) - 1e-6) / pi - 1)
//             bilinear, align_corners, zero padding (equirect_query)
//   local_c = max(sum_k Y_k(d) shs[k, c], 0)           (SH degree 3, 16 coeffs)
//   glob_c  = env_c vis, light_c = local_c + glob_c
//   trans_c = light_c area max(n . d, 0)
//   f_s     = GGX(n, v, d, roughness)                  (ops/shading.py)
// and writes the sample means of trans (the diffuse light), f_s trans (the
// specular), light, local, glob and vis, and pbr = bc / pi dif + spec. No
// per-sample value leaves the kernel.
//
// Precision: float32 throughout, IEEE divides and square roots, acosf,
// atan2f and exp2f; no fast-math flags. The eval has no gradient, so no clip
// decision is taken from float64 (the value is continuous across each clip).
// Two quantities are taken as K4 (csrc/shading.cu) takes them, for the value
// itself: sign(V.N), which turns N to the viewer and so changes f_s, from V
// and N normalised and dotted in double; and the GGX denominator's nom0 =
// NoH^2 (alpha^2 - 1) + 1 as |n x h|^2 + NoH^2 alpha^2 with the half vector
// keeping V's float32 rounding error, which keeps f_s near the specular peak
// of a smooth surface within ~1e-5 of float64 where the direct form cancels.
// The env lookup repeats PyTorch's grid_sample arithmetic (source index
// ((g + 1) / 2) (size - 1), floor, the four corner weights); a corner outside
// the map adds nothing, which happens at gy < -1 (d'z near 1: phi = -1e-6).
// The map is read through the read-only path; at 512 x 1024 x 3 floats
// (6.3 MB) it stays in L2.
//
// What bounds it on the H100. Per (point, sample) it reads 20 bytes (dir,
// visibility, area), per point ~230 bytes of fields and SH and writes 76:
// ~483 MB at P = 300,000, S = 64, 0.144 ms at 3.35 TB/s; some 290 FP32
// operations a sample (chip_smoke.py K6_OPS), 0.083 ms at 67 TFLOP/s.
//
// Design. A warp owns a point: lane l takes samples l, l + 32, ..., two at a
// time (both loaded before either is shaded), so a warp's reads of [P, S, .]
// are contiguous; any S, a lane past S adds nothing. The point's set-up runs
// once a warp (the same instructions on every lane). The 16 sums (3
// channels of diffuse, specular, light, local, global, and visibility)
// finish in one reduce-scatter over the warp (composite_warp.cuh: 16
// shuffles), after which lane 2t holds sum t and writes it. A block is
// kWarps = 4 points; nothing is staged in shared memory. The launch bounds
// keep 6 blocks an SM (24 warps) at 80 registers, none spilled. On an H100
// 80GB HBM3 at 700 W, at P = 300,000, S = 64 and a 512 x 1024 map, this
// shape took 0.78 ms a launch; 2 to 16 warps a block at 64 to 95
// registers took 0.78-1.28 ms (64 registers spill): about 5.4x the bytes'
// bound, held by the latency of each warp's chain (the point's set-up,
// then its samples' loads, the lookup's gathers from L2, the reduction).
//
// Plain C interface (built by nvcc into a shared library, bound with ctypes):
// r3dg_shade_eval returns the first CUDA error, or 0.

#include <cstdint>

#include <cuda_runtime.h>

#include "composite_warp.cuh"

namespace {

constexpr int kWarps = 4;                    // points per block
constexpr int kThreads = 32 * kWarps;        // 128
constexpr int kSH = 16;                      // degree-3 SH coefficients
constexpr int kSHC = 3 * kSH;                // [16, 3] per point
constexpr int kSums = 16;
constexpr float kPi = 3.14159265358979323846f;
constexpr float k4Pi = 4.f * kPi;
constexpr float kFresnel = 0.04f;

// Slots of the per-lane sums, 3 channels each but the last.
constexpr int kDif = 0, kSpec = 3, kLight = 6, kLocal = 9, kGlobal = 12,
              kVis = 15;

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Degree-3 real SH basis, in utils/sh.py order and sign convention (as
// csrc/shading.cu::sh_basis).
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* b) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  b[0] = 0.28209479177387814f;
  b[1] = -0.4886025119029199f * y;
  b[2] = 0.4886025119029199f * z;
  b[3] = -0.4886025119029199f * x;
  b[4] = 1.0925484305920792f * xy;
  b[5] = -1.0925484305920792f * yz;
  b[6] = 0.31539156525252005f * (2.f * zz - xx - yy);
  b[7] = -1.0925484305920792f * xz;
  b[8] = 0.5462742152960396f * (xx - yy);
  b[9] = -0.5900435899266435f * y * (3.f * xx - yy);
  b[10] = 2.890611442640554f * xy * z;
  b[11] = -0.4570457994644658f * y * (4.f * zz - xx - yy);
  b[12] = 0.3731763325901154f * z * (2.f * zz - 3.f * xx - 3.f * yy);
  b[13] = -0.4570457994644658f * x * (4.f * zz - xx - yy);
  b[14] = 1.445305721320277f * z * (xx - yy);
  b[15] = -0.5900435899266435f * x * (xx - 3.f * yy);
}

// Per-point quantities shared by every sample.
struct Point {
  float nx, ny, nz;                 // normal as given (transport)
  float vx, vy, vz;                 // unit view direction
  float vlx, vly, vlz;              // its rounding error (see ggx)
  float nsx, nsy, nsz;              // unit normal turned towards v
  float alpha2, k, nom1;
  float t[9];                       // the light transform, row-major
  bool transformed;
};

// As csrc/shading.cu::load_point, for the value alone: sign(V.N) from V and
// N normalised and dotted in double.
__device__ __forceinline__ Point load_point(const float* __restrict__ nrm,
                                            const float* __restrict__ vdir,
                                            const float* __restrict__ rough,
                                            const float* __restrict__ tf,
                                            int p) {
  Point q;
  q.nx = nrm[3 * p]; q.ny = nrm[3 * p + 1]; q.nz = nrm[3 * p + 2];
  const float vdx = vdir[3 * p], vdy = vdir[3 * p + 1], vdz = vdir[3 * p + 2];
  const float M_v = fmaxf(sqrtf(vdx * vdx + vdy * vdy + vdz * vdz), 1e-12f);
  q.vx = vdx / M_v; q.vy = vdy / M_v; q.vz = vdz / M_v;
  const double M_vd = fmax(sqrt(static_cast<double>(vdx) * vdx
                                + static_cast<double>(vdy) * vdy
                                + static_cast<double>(vdz) * vdz), 1e-12);
  const double Vx = vdx / M_vd, Vy = vdy / M_vd, Vz = vdz / M_vd;
  q.vlx = static_cast<float>(Vx - q.vx);
  q.vly = static_cast<float>(Vy - q.vy);
  q.vlz = static_cast<float>(Vz - q.vz);
  const float M_n = fmaxf(sqrtf(q.nx * q.nx + q.ny * q.ny + q.nz * q.nz),
                          1e-12f);
  const double M_nd = fmax(sqrt(static_cast<double>(q.nx) * q.nx
                                + static_cast<double>(q.ny) * q.ny
                                + static_cast<double>(q.nz) * q.nz), 1e-12);
  const double s = Vx * (q.nx / M_nd) + Vy * (q.ny / M_nd) + Vz * (q.nz / M_nd);
  const float sgn = s > 0.0 ? 1.f : (s < 0.0 ? -1.f : 0.f);
  q.nsx = q.nx / M_n * sgn; q.nsy = q.ny / M_n * sgn; q.nsz = q.nz / M_n * sgn;
  const float r = rough[p];
  const float alpha = r * r;
  q.alpha2 = alpha * alpha;
  q.k = (alpha + 2.f * r + 1.f) / 8.f;
  const float NoV = clip(q.nsx * q.vx + q.nsy * q.vy + q.nsz * q.vz, 1e-6f, 1.f);
  q.nom1 = NoV * (1.f - q.k) + q.k;
  q.transformed = tf != nullptr;
#pragma unroll
  for (int i = 0; i < 9; ++i) q.t[i] = q.transformed ? tf[i] : 0.f;
  return q;
}

// One sample's GGX specular reflectance f_s (csrc/shading.cu::ggx, its
// value alone).
__device__ __forceinline__ float ggx(const Point& pt, float dx, float dy,
                                     float dz) {
  // h0 = (d + V) / 2 with V to twice float32's precision: where d is near
  // -V, d + V cancels and V's rounding would be all of h0's error.
  const float h0x = ((dx + pt.vx) + pt.vlx) * 0.5f;
  const float h0y = ((dy + pt.vy) + pt.vly) * 0.5f;
  const float h0z = ((dz + pt.vz) + pt.vlz) * 0.5f;
  const float rM_h = 1.f / fmaxf(sqrtf(h0x * h0x + h0y * h0y + h0z * h0z),
                                 1e-12f);
  const float hx = h0x * rM_h, hy = h0y * rM_h, hz = h0z * rM_h;
  const float NoL = clip(pt.nsx * dx + pt.nsy * dy + pt.nsz * dz, 1e-6f, 1.f);
  const float NoH_raw = pt.nsx * hx + pt.nsy * hy + pt.nsz * hz;
  const float NoH = clip(NoH_raw, 1e-6f, 1.f);
  const float VoH = clip(pt.vx * hx + pt.vy * hy + pt.vz * hz, 1e-6f, 1.f);
  const float FMi = (-5.55473f * VoH - 6.98316f) * VoH;
  const float frac = (kFresnel + (1.f - kFresnel) * exp2f(FMi)) * pt.alpha2;
  // nom0 = NoH^2 (alpha2 - 1) + 1 = (1 - NoH^2) + NoH^2 alpha2, with 1 -
  // NoH^2 as |ns x h|^2 (no cancellation at the peak); below the clip NoH
  // is 1e-6.
  float sin2;
  if (NoH_raw >= 1e-6f) {
    const float cx = pt.nsy * hz - pt.nsz * hy;
    const float cy = pt.nsz * hx - pt.nsx * hz;
    const float cz = pt.nsx * hy - pt.nsy * hx;
    sin2 = cx * cx + cy * cy + cz * cz;
  } else {
    sin2 = 1.f - NoH * NoH;
  }
  const float nom0 = sin2 + NoH * NoH * pt.alpha2;
  const float nom2 = NoL * (1.f - pt.k) + pt.k;
  const float q = k4Pi * nom0 * nom0 * pt.nom1 * nom2;
  return frac / clip(q, 1e-6f, k4Pi);
}

// The env map's radiance for direction (x, y, z) as models/lights.py::
// equirect_query and F.grid_sample (bilinear, align_corners, zeros) give it.
__device__ __forceinline__ void env_lookup(const Point& pt,
                                           const float* __restrict__ env,
                                           int H, int W, float x, float y,
                                           float z, float* out) {
  if (pt.transformed) {             // d @ T^T
    const float tx = pt.t[0] * x + pt.t[1] * y + pt.t[2] * z;
    const float ty = pt.t[3] * x + pt.t[4] * y + pt.t[5] * z;
    const float tz = pt.t[6] * x + pt.t[7] * y + pt.t[8] * z;
    x = tx; y = ty; z = tz;
  }
  const float phi = acosf(clip(z, -1.f, 1.f)) - 1e-6f;
  const float theta = atan2f(y, x);
  const float gy = (phi / kPi) * 2.f - 1.f;
  const float gx = -theta / kPi;
  const float ix = ((gx + 1.f) / 2.f) * static_cast<float>(W - 1);
  const float iy = ((gy + 1.f) / 2.f) * static_cast<float>(H - 1);
  const float fx = floorf(ix), fy = floorf(iy);
  const int x0 = static_cast<int>(fx), y0 = static_cast<int>(fy);
  const float wx1 = ix - fx, wx0 = (fx + 1.f) - ix;
  const float wy1 = iy - fy, wy0 = (fy + 1.f) - iy;
  const float w[4] = {wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1};
  out[0] = out[1] = out[2] = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < 4; ++c4) {
    const int xi = x0 + (c4 & 1), yi = y0 + (c4 >> 1);
    if (xi >= 0 && xi < W && yi >= 0 && yi < H) {
      const float* t = env + 3 * (static_cast<size_t>(yi) * W + xi);
      out[0] += __ldg(t) * w[c4];
      out[1] += __ldg(t + 1) * w[c4];
      out[2] += __ldg(t + 2) * w[c4];
    }
  }
}

// One sample in registers.
struct Sample {
  float dx, dy, dz, vis, area;
};

__device__ __forceinline__ Sample load_sample(const float* __restrict__ dirs,
                                              const float* __restrict__ vis,
                                              const float* __restrict__ area,
                                              size_t i, bool valid) {
  if (!valid) return {0.f, 0.f, 1.f, 0.f, 0.f};
  return {__ldg(dirs + 3 * i), __ldg(dirs + 3 * i + 1),
          __ldg(dirs + 3 * i + 2), __ldg(vis + i), __ldg(area + i)};
}

// Adds one sample's terms into the lane's sums.
__device__ __forceinline__ void shade_sample(const Point& pt, const Sample& s,
                                             const float* __restrict__ shs_p,
                                             const float* __restrict__ env,
                                             int H, int W, float* acc) {
  float basis[kSH];
  sh_basis(s.dx, s.dy, s.dz, basis);
  float e[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kSHC; ++j) e[j % 3] += basis[j / 3] * __ldg(shs_p + j);
  float env_c[3];
  env_lookup(pt, env, H, W, s.dx, s.dy, s.dz, env_c);
  const float an = s.area * fmaxf(pt.nx * s.dx + pt.ny * s.dy + pt.nz * s.dz,
                                  0.f);
  const float f_s = ggx(pt, s.dx, s.dy, s.dz);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float local = fmaxf(e[c], 0.f);
    const float glob = env_c[c] * s.vis;
    const float light = local + glob;
    const float trans = light * an;
    acc[kDif + c] += trans;
    acc[kSpec + c] += f_s * trans;
    acc[kLight + c] += light;
    acc[kLocal + c] += local;
    acc[kGlobal + c] += glob;
  }
  acc[kVis] += s.vis;
}

__global__ void __launch_bounds__(kThreads, 6)
shade_eval_kernel(const float* __restrict__ dirs,   // [P, S, 3]
                  const float* __restrict__ vis,    // [P, S]
                  const float* __restrict__ area,   // [P, S]
                  const float* __restrict__ bc,     // [P, 3]
                  const float* __restrict__ rough,  // [P]
                  const float* __restrict__ nrm,    // [P, 3]
                  const float* __restrict__ vdir,   // [P, 3]
                  const float* __restrict__ shs,    // [P, 48]
                  const float* __restrict__ env,    // [H, W, 3]
                  const float* __restrict__ tf,     // [3, 3] or null
                  int P, int S, int H, int W,
                  float* __restrict__ pbr,          // [P, 3]
                  float* __restrict__ dif,          // [P, 3]
                  float* __restrict__ spec,         // [P, 3]
                  float* __restrict__ light,        // [P, 3]
                  float* __restrict__ local,        // [P, 3]
                  float* __restrict__ glob,         // [P, 3]
                  float* __restrict__ vis_mean) {   // [P]
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + threadIdx.x / 32;
  if (p >= P) return;               // the whole warp leaves together
  const Point pt = load_point(nrm, vdir, rough, tf, p);
  const float* shs_p = shs + static_cast<size_t>(p) * kSHC;
  const size_t s0 = static_cast<size_t>(p) * S;

  float acc[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < S; j0 += 64) {
    const int ja = j0 + lane, jb = ja + 32;
    const Sample a = load_sample(dirs, vis, area, s0 + ja, ja < S);
    const Sample b = load_sample(dirs, vis, area, s0 + jb, jb < S);
    if (ja < S) shade_sample(pt, a, shs_p, env, H, W, acc);
    if (jb < S) shade_sample(pt, b, shs_p, env, H, W, acc);
  }
  // sum t on lanes 2t and 2t + 1
  const float sum = r3dg::reduce_scatter<kSums>(acc, lane);
  const int t = lane >> 1;
  const float mean = sum / static_cast<float>(S);
  // lane 2 (kSpec + c) takes the diffuse mean of lane 2 (kDif + c)
  const float dif_c = __shfl_sync(r3dg::kFullMask, mean,
                                  (lane + 32 - 2 * (kSpec - kDif)) & 31);
  if (lane & 1) return;
  float* const outs[5] = {dif, spec, light, local, glob};
  if (t == kVis) {
    vis_mean[p] = mean;
  } else {
    const int c = t % 3;
    outs[t / 3][3 * p + c] = mean;
    if (t / 3 == kSpec / 3) pbr[3 * p + c] = bc[3 * p + c] / kPi * dif_c + mean;
  }
}

}  // namespace

extern "C" int r3dg_shade_eval(const void* dirs, const void* vis,
                               const void* area, const void* bc,
                               const void* rough, const void* nrm,
                               const void* vdir, const void* shs,
                               const void* env, const void* tf, int P, int S,
                               int H, int W, void* pbr, void* dif, void* spec,
                               void* light, void* local, void* glob,
                               void* vis_mean, void* stream) {
  if (P <= 0) return 0;
  if (S < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (P + kWarps - 1) / kWarps;
  shade_eval_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(vis),
      static_cast<const float*>(area), static_cast<const float*>(bc),
      static_cast<const float*>(rough), static_cast<const float*>(nrm),
      static_cast<const float*>(vdir), static_cast<const float*>(shs),
      static_cast<const float*>(env), static_cast<const float*>(tf), P, S, H,
      W, static_cast<float*>(pbr), static_cast<float*>(dif),
      static_cast<float*>(spec), static_cast<float*>(light),
      static_cast<float*>(local), static_cast<float*>(glob),
      static_cast<float*>(vis_mean));
  return static_cast<int>(cudaGetLastError());
}

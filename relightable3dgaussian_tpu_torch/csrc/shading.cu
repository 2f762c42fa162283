// Kernel K4: fused stage-2 train shading, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels
// relightable3dgaussian_tpu/ops/shading_pallas.py::_fwd_kernel and ::_bwd_kernel
// (launched by _shade_core_fwd / _shade_core_bwd under rendering_equation_train).
// Per point, over its S incident samples (dir d, visibility, area, global light
// gl, the env radiance already looked up):
//   local_c = max(sum_k Y_k(d) shs[k, c], 0)           (SH degree 3, 16 coeffs)
//   light_c = local_c + gl_c * vis
//   trans_c = light_c * area * max(n . d, 0)
//   f_s     = GGX(n, v, d, roughness)                  (ops/shading.py)
//   dif_c = mean_s trans_c, spec_c = mean_s f_s trans_c, pbr_c = bc_c/pi dif_c + spec_c
// with the same clip masks, sign(N.V) flip, exp2 Fresnel and zero-length guards
// (sel_h, sel_v) as _chain / _bwd_math (shading_pallas.py:80-249). Two
// differences from the TPU kernel, both towards the jnp chain that is the
// JAX package's default train shading (ops/shading.py):
//   * max(e, 0) of the local light passes half the gradient at e == 0, as
//     jnp.maximum does (the TPU kernel passes none, so SH that start at zero
//     never train);
//   * the GGX denominator's nom0 = NoH^2 (alpha^2 - 1) + 1 is taken as
//     |n x h|^2 + NoH^2 alpha^2. At the specular peak of a smooth surface
//     1 - NoH^2 cancels, so a last bit of NoH moves f_s by ~1e-3 of itself
//     in the direct form; the cross product keeps f_s within ~1e-5 of the
//     float64 answer. For the same reason the backward projects the
//     gradients of NoH and NoV off h and v with cross products
//     (h x (n x h), v x (n x v)), and masks them, and VoH's, at the lower
//     clip only: dot products of unit vectors pass 1 only by rounding.
//     The same quantities, better conditioned.
// The backward
// recomputes the forward chain, as the TPU kernel does, and returns the analytic
// VJP for base colour, roughness, view direction, the local-light SH and the
// per-sample global light (dgl [P, S, 3]); torch chains dgl into the env map
// through grid_sample's backward. Normals, visibility, directions and areas are
// constants of the train step and get no gradient. expf/exp2f, no fast math.
//
// Design: one warp per point, 8 points per block. The per-point inputs are read
// once (the 48 SH coefficients into shared memory, read by broadcast); lanes
// stride over the samples, keep their sums in registers, and the per-point sums
// are finished by warp shuffles (6 in the forward: dif and spec; 57 in the
// backward: dif 3, dshs 48, three GGX scalars, and a 3-vector for v).
// Per-sample inputs keep the natural [P, S, 3] / [P, S] layouts, so a warp's
// loads of one sample step are contiguous.
//
// What bounds it on the H100: the forward streams 32 bytes per sample
// ([P, S, 3] dirs and global light, [P, S] visibility and area) for ~150 FP32
// operations, so it is near the bandwidth/compute balance; the backward also
// writes 12 bytes of dgl per sample and holds 48 SH-gradient accumulators
// per lane, so registers bound its occupancy.
//
// Plain C interface (built by nvcc into a shared library, bound with ctypes):
// r3dg_shade_fwd and r3dg_shade_bwd return the first CUDA error, or 0.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // points per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kSH = 16;                // degree-3 SH coefficients
constexpr int kSHC = 3 * kSH;          // [16, 3] per point
constexpr float kPi = 3.14159265358979323846f;
constexpr float k4Pi = 4.f * kPi;
constexpr float kFresnel = 0.04f;
constexpr float kLn2 = 0.69314718055994530942f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ bool inside(float x, float lo, float hi) {
  return x >= lo && x <= hi;
}

// Degree-3 real SH basis, in utils/sh.py order and sign convention.
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
  float vdx, vdy, vdz, m_v, M_v;    // view direction and its length
  float vx, vy, vz;                 // unit view direction
  float nsx, nsy, nsz;              // unit normal flipped towards v
  float r, alpha, alpha2, k;
  float NoV_raw, NoV, nom1;
};

__device__ __forceinline__ Point load_point(const float* __restrict__ nrm,
                                            const float* __restrict__ vdir,
                                            const float* __restrict__ rough,
                                            int p) {
  Point q;
  q.nx = nrm[3 * p]; q.ny = nrm[3 * p + 1]; q.nz = nrm[3 * p + 2];
  q.vdx = vdir[3 * p]; q.vdy = vdir[3 * p + 1]; q.vdz = vdir[3 * p + 2];
  q.m_v = sqrtf(q.vdx * q.vdx + q.vdy * q.vdy + q.vdz * q.vdz);
  q.M_v = fmaxf(q.m_v, 1e-12f);
  q.vx = q.vdx / q.M_v; q.vy = q.vdy / q.M_v; q.vz = q.vdz / q.M_v;
  const float M_n = fmaxf(sqrtf(q.nx * q.nx + q.ny * q.ny + q.nz * q.nz), 1e-12f);
  const float nhx = q.nx / M_n, nhy = q.ny / M_n, nhz = q.nz / M_n;
  const float s = q.vx * nhx + q.vy * nhy + q.vz * nhz;
  const float sgn = s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
  q.nsx = nhx * sgn; q.nsy = nhy * sgn; q.nsz = nhz * sgn;
  q.r = rough[p];
  q.alpha = q.r * q.r;
  q.alpha2 = q.alpha * q.alpha;
  q.k = (q.alpha + 2.f * q.r + 1.f) / 8.f;
  q.NoV_raw = q.nsx * q.vx + q.nsy * q.vy + q.nsz * q.vz;
  q.NoV = clip(q.NoV_raw, 1e-6f, 1.f);
  q.nom1 = q.NoV * (1.f - q.k) + q.k;
  return q;
}

// One sample's forward chain (_chain), with what the backward reads.
struct Sample {
  float dx, dy, dz;
  float h0x, h0y, h0z, m_h, M_h, hx, hy, hz;
  float NoL_raw, NoH_raw, VoH_raw, NoL, NoH, VoH;
  float cx, cy, cz;                  // ns x h, zero below the NoH clip
  float e2, frac0, u, nom0, nom2, q, nom, f_s;
  float an, vis;
  float e[3], trans[3];
  float basis[kSH];
};

__device__ __forceinline__ void sample_forward(
    const Point& pt, const float* __restrict__ dirs,
    const float* __restrict__ vis, const float* __restrict__ area,
    const float* __restrict__ gl, const float* shs, size_t ps, Sample& s) {
  s.dx = dirs[3 * ps]; s.dy = dirs[3 * ps + 1]; s.dz = dirs[3 * ps + 2];
  s.vis = vis[ps];
  s.h0x = (s.dx + pt.vx) * 0.5f;
  s.h0y = (s.dy + pt.vy) * 0.5f;
  s.h0z = (s.dz + pt.vz) * 0.5f;
  s.m_h = sqrtf(s.h0x * s.h0x + s.h0y * s.h0y + s.h0z * s.h0z);
  s.M_h = fmaxf(s.m_h, 1e-12f);
  s.hx = s.h0x / s.M_h; s.hy = s.h0y / s.M_h; s.hz = s.h0z / s.M_h;
  s.NoL_raw = pt.nsx * s.dx + pt.nsy * s.dy + pt.nsz * s.dz;
  s.NoH_raw = pt.nsx * s.hx + pt.nsy * s.hy + pt.nsz * s.hz;
  s.VoH_raw = pt.vx * s.hx + pt.vy * s.hy + pt.vz * s.hz;
  s.NoL = clip(s.NoL_raw, 1e-6f, 1.f);
  s.NoH = clip(s.NoH_raw, 1e-6f, 1.f);
  s.VoH = clip(s.VoH_raw, 1e-6f, 1.f);
  const float FMi = (-5.55473f * s.VoH - 6.98316f) * s.VoH;
  s.e2 = exp2f(FMi);
  s.frac0 = kFresnel + (1.f - kFresnel) * s.e2;
  s.u = s.frac0 * pt.alpha2;
  // nom0 = NoH^2 (alpha2 - 1) + 1 = (1 - NoH^2) + NoH^2 alpha2. Near the
  // peak 1 - NoH^2 cancels; |ns x h|^2 is the same quantity without the
  // cancellation (see the note at the top). Below the clip, NoH is 1e-6.
  float sin2;
  if (s.NoH_raw >= 1e-6f) {
    s.cx = pt.nsy * s.hz - pt.nsz * s.hy;
    s.cy = pt.nsz * s.hx - pt.nsx * s.hz;
    s.cz = pt.nsx * s.hy - pt.nsy * s.hx;
    sin2 = s.cx * s.cx + s.cy * s.cy + s.cz * s.cz;
  } else {
    s.cx = s.cy = s.cz = 0.f;
    sin2 = 1.f - s.NoH * s.NoH;
  }
  s.nom0 = sin2 + s.NoH * s.NoH * pt.alpha2;
  s.nom2 = s.NoL * (1.f - pt.k) + pt.k;
  s.q = k4Pi * s.nom0 * s.nom0 * pt.nom1 * s.nom2;
  s.nom = clip(s.q, 1e-6f, k4Pi);
  s.f_s = s.u / s.nom;

  sh_basis(s.dx, s.dy, s.dz, s.basis);
  const float ndi = fmaxf(pt.nx * s.dx + pt.ny * s.dy + pt.nz * s.dz, 0.f);
  s.an = area[ps] * ndi;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = s.basis[0] * shs[c];
#pragma unroll
    for (int k = 1; k < kSH; ++k) acc += s.basis[k] * shs[3 * k + c];
    s.e[c] = acc;
    s.trans[c] = (fmaxf(acc, 0.f) + gl[3 * ps + c] * s.vis) * s.an;
  }
}

__device__ __forceinline__ void load_shs(const float* __restrict__ shs, int p,
                                         int lane, float* s_shs) {
  for (int i = lane; i < kSHC; i += 32) s_shs[i] = shs[static_cast<size_t>(p) * kSHC + i];
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
shade_fwd_kernel(const float* __restrict__ dirs,   // [P, S, 3]
                 const float* __restrict__ vis,    // [P, S]
                 const float* __restrict__ area,   // [P, S]
                 const float* __restrict__ gl,     // [P, S, 3]
                 const float* __restrict__ bc,     // [P, 3]
                 const float* __restrict__ rough,  // [P]
                 const float* __restrict__ nrm,    // [P, 3]
                 const float* __restrict__ vdir,   // [P, 3]
                 const float* __restrict__ shs,    // [P, 48]
                 int P, int S,
                 float* __restrict__ pbr,          // [P, 3]
                 float* __restrict__ dif,          // [P, 3]
                 float* __restrict__ spec) {       // [P, 3]
  __shared__ float s_shs[kWarps][kSHC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= P) return;  // whole warps only
  load_shs(shs, p, lane, s_shs[warp]);
  const Point pt = load_point(nrm, vdir, rough, p);

  float a_dif[3] = {0.f, 0.f, 0.f}, a_spec[3] = {0.f, 0.f, 0.f};
  for (int j = lane; j < S; j += 32) {
    Sample s;
    sample_forward(pt, dirs, vis, area, gl, s_shs[warp],
                   static_cast<size_t>(p) * S + j, s);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a_dif[c] += s.trans[c];
      a_spec[c] += s.f_s * s.trans[c];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float d = warp_sum(a_dif[c]) / S;
    const float sp = warp_sum(a_spec[c]) / S;
    if (lane == c) {
      dif[3 * p + c] = d;
      spec[3 * p + c] = sp;
      pbr[3 * p + c] = bc[3 * p + c] / kPi * d + sp;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
shade_bwd_kernel(const float* __restrict__ dirs, const float* __restrict__ vis,
                 const float* __restrict__ area, const float* __restrict__ gl,
                 const float* __restrict__ bc, const float* __restrict__ rough,
                 const float* __restrict__ nrm, const float* __restrict__ vdir,
                 const float* __restrict__ shs,
                 const float* __restrict__ gpbr,   // [P, 3]
                 const float* __restrict__ gdif,   // [P, 3]
                 const float* __restrict__ gspec,  // [P, 3]
                 int P, int S,
                 float* __restrict__ dbc,          // [P, 3]
                 float* __restrict__ drough,       // [P]
                 float* __restrict__ dvdir,        // [P, 3]
                 float* __restrict__ dshs,         // [P, 48]
                 float* __restrict__ dgl) {        // [P, S, 3]
  __shared__ float s_shs[kWarps][kSHC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= P) return;
  load_shs(shs, p, lane, s_shs[warp]);
  const Point pt = load_point(nrm, vdir, rough, p);
  const float inv_s = 1.f / S;
  float gD[3], gS[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float gpc = gpbr[3 * p + c];
    gD[c] = gdif[3 * p + c] + gpc * bc[3 * p + c] / kPi;
    gS[c] = gspec[3 * p + c] + gpc;
  }

  float a_dif[3] = {0.f, 0.f, 0.f};
  float a_shs[kSHC];
#pragma unroll
  for (int i = 0; i < kSHC; ++i) a_shs[i] = 0.f;
  float a_galpha2 = 0.f, a_gnom1 = 0.f, a_gk2 = 0.f;
  float a_gvx = 0.f, a_gvy = 0.f, a_gvz = 0.f;

  for (int j = lane; j < S; j += 32) {
    const size_t ps = static_cast<size_t>(p) * S + j;
    Sample s;
    sample_forward(pt, dirs, vis, area, gl, s_shs[warp], ps, s);
    float gf = 0.f, ge[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a_dif[c] += s.trans[c];
      const float gtrans = (gD[c] + gS[c] * s.f_s) * inv_s;
      gf += gS[c] * s.trans[c] * inv_s;
      const float glight = gtrans * s.an;
      dgl[3 * ps + c] = glight * s.vis;
      // max(e, 0) passes half the gradient at e == 0, as jnp.maximum and
      // torch.maximum do: the local-light SH start at zero in stage 2.
      ge[c] = s.e[c] > 0.f ? glight : (s.e[c] == 0.f ? 0.5f * glight : 0.f);
    }
#pragma unroll
    for (int k = 0; k < kSH; ++k) {
#pragma unroll
      for (int c = 0; c < 3; ++c) a_shs[3 * k + c] += s.basis[k] * ge[c];
    }

    // GGX backward
    const float gu = gf / s.nom;
    const float gq = inside(s.q, 1e-6f, k4Pi) ? -gf * s.u / (s.nom * s.nom) : 0.f;
    const float gfrac0 = gu * pt.alpha2;
    a_galpha2 += gu * s.frac0;
    // NoH, VoH and NoV are dot products of unit vectors: they pass 1 only
    // by rounding, so only the lower clip masks their gradients.
    const float gVoH = s.VoH_raw >= 1e-6f
        ? gfrac0 * (1.f - kFresnel) * kLn2 * s.e2 * (-2.f * 5.55473f * s.VoH - 6.98316f)
        : 0.f;
    const float gnom0 = gq * k4Pi * 2.f * s.nom0 * pt.nom1 * s.nom2;
    a_gnom1 += gq * k4Pi * s.nom0 * s.nom0 * s.nom2;
    const float gnom2 = gq * k4Pi * s.nom0 * s.nom0 * pt.nom1;
    a_galpha2 += gnom0 * s.NoH * s.NoH;
    const float gNoH = s.NoH_raw >= 1e-6f
        ? gnom0 * 2.f * s.NoH * (pt.alpha2 - 1.f) : 0.f;
    a_gk2 += gnom2 * (1.f - s.NoL);
    a_gvx += gVoH * s.hx;
    a_gvy += gVoH * s.hy;
    a_gvz += gVoH * s.hz;

    // H = h0 / max(|h0|, eps), h0 = (d + v) / 2: gh0 = (gH - (gH.h) h) / |h0|
    // for gH = gNoH ns + gVoH v. Near the peak ns - NoH h cancels, so it is
    // taken as h x (ns x h). Below |h0| = 1e-12, gh0 = gH / 1e-12.
    float ghx, ghy, ghz;
    if (s.m_h > 1e-12f) {
      ghx = gNoH * (s.hy * s.cz - s.hz * s.cy) + gVoH * (pt.vx - s.VoH_raw * s.hx);
      ghy = gNoH * (s.hz * s.cx - s.hx * s.cz) + gVoH * (pt.vy - s.VoH_raw * s.hy);
      ghz = gNoH * (s.hx * s.cy - s.hy * s.cx) + gVoH * (pt.vz - s.VoH_raw * s.hz);
    } else {
      ghx = gNoH * pt.nsx + gVoH * pt.vx;
      ghy = gNoH * pt.nsy + gVoH * pt.vy;
      ghz = gNoH * pt.nsz + gVoH * pt.vz;
    }
    a_gvx += 0.5f * ghx / s.M_h;
    a_gvy += 0.5f * ghy / s.M_h;
    a_gvz += 0.5f * ghz / s.M_h;
  }

#pragma unroll
  for (int i = 0; i < kSHC; ++i) {
    const float v = warp_sum(a_shs[i]);
    if (lane == (i & 31)) dshs[static_cast<size_t>(p) * kSHC + i] = v;
  }
  const float galpha2 = warp_sum(a_galpha2);
  const float gnom1 = warp_sum(a_gnom1);
  const float gk = gnom1 * (1.f - pt.NoV) + warp_sum(a_gk2);
  float gvhx = warp_sum(a_gvx), gvhy = warp_sum(a_gvy), gvhz = warp_sum(a_gvz);
  float difc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) difc[c] = warp_sum(a_dif[c]) / S;
  if (lane != 0) return;

  const float gNoV = pt.NoV_raw >= 1e-6f ? gnom1 * (1.f - pt.k) : 0.f;
  const float galpha = galpha2 * 2.f * pt.alpha + gk * (1.f / 8.f);
  drough[p] = galpha * 2.f * pt.r + gk * 0.25f;
  // V-hat = vdir / max(|vdir|, eps): dvdir = (gvh - (gvh.v) v) / |vdir| for
  // gvh = gNoV ns + (the sums above). Viewed head-on, ns - NoV v cancels, so
  // it is taken as v x (ns x v). Below |vdir| = 1e-12, dvdir = gvh / 1e-12.
  float dvx, dvy, dvz;
  if (pt.m_v > 1e-12f) {
    const float ex = pt.nsy * pt.vz - pt.nsz * pt.vy;
    const float ey = pt.nsz * pt.vx - pt.nsx * pt.vz;
    const float ez = pt.nsx * pt.vy - pt.nsy * pt.vx;
    const float rv = gvhx * pt.vx + gvhy * pt.vy + gvhz * pt.vz;
    dvx = gNoV * (pt.vy * ez - pt.vz * ey) + gvhx - rv * pt.vx;
    dvy = gNoV * (pt.vz * ex - pt.vx * ez) + gvhy - rv * pt.vy;
    dvz = gNoV * (pt.vx * ey - pt.vy * ex) + gvhz - rv * pt.vz;
  } else {
    dvx = gvhx + gNoV * pt.nsx;
    dvy = gvhy + gNoV * pt.nsy;
    dvz = gvhz + gNoV * pt.nsz;
  }
  dvdir[3 * p] = dvx / pt.M_v;
  dvdir[3 * p + 1] = dvy / pt.M_v;
  dvdir[3 * p + 2] = dvz / pt.M_v;
#pragma unroll
  for (int c = 0; c < 3; ++c) dbc[3 * p + c] = gpbr[3 * p + c] * difc[c] / kPi;
}

}  // namespace

extern "C" int r3dg_shade_fwd(const void* dirs, const void* vis,
                              const void* area, const void* gl, const void* bc,
                              const void* rough, const void* nrm,
                              const void* vdir, const void* shs, int P, int S,
                              void* pbr, void* dif, void* spec, void* stream) {
  if (P <= 0) return 0;
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (P + kWarps - 1) / kWarps;
  shade_fwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(vis),
      static_cast<const float*>(area), static_cast<const float*>(gl),
      static_cast<const float*>(bc), static_cast<const float*>(rough),
      static_cast<const float*>(nrm), static_cast<const float*>(vdir),
      static_cast<const float*>(shs), P, S, static_cast<float*>(pbr),
      static_cast<float*>(dif), static_cast<float*>(spec));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int r3dg_shade_bwd(const void* dirs, const void* vis,
                              const void* area, const void* gl, const void* bc,
                              const void* rough, const void* nrm,
                              const void* vdir, const void* shs,
                              const void* gpbr, const void* gdif,
                              const void* gspec, int P, int S, void* dbc,
                              void* drough, void* dvdir, void* dshs, void* dgl,
                              void* stream) {
  if (P <= 0) return 0;
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (P + kWarps - 1) / kWarps;
  shade_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(vis),
      static_cast<const float*>(area), static_cast<const float*>(gl),
      static_cast<const float*>(bc), static_cast<const float*>(rough),
      static_cast<const float*>(nrm), static_cast<const float*>(vdir),
      static_cast<const float*>(shs), static_cast<const float*>(gpbr),
      static_cast<const float*>(gdif), static_cast<const float*>(gspec), P, S,
      static_cast<float*>(dbc), static_cast<float*>(drough),
      static_cast<float*>(dvdir), static_cast<float*>(dshs),
      static_cast<float*>(dgl));
  return static_cast<int>(cudaGetLastError());
}

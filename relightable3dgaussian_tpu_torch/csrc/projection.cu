// K7: the projection of every gaussian, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its ops/projection.py::
// preprocess to XLA. The port's plain version is ops/projection.py::
// preprocess_plain (eager PyTorch, which CPU tensors take), and the
// backward's formulas are written out in plain PyTorch as ops/projection.py::
// projection_backward_plain, the specification the CPU tests hold against
// autograd. Per gaussian, with the camera's transposed world_view V and
// full_proj F (points are row vectors, [x y z 1] @ V):
//   t = [m 1] V (depth t_z, culled at t_z <= 0.2); h = [m 1] F,
//   mean2d = ((h_xy / (h_w + 1e-7) + 1) size - 1) / 2 (+ mean2d_offset);
//   Sigma = R S S^T R^T of the normalised quaternion and modifier x scale,
//   or cov3d_precomp (packed [6], or the full [9] used unsymmetrised);
//   J the EWA Jacobian at t with t_x/t_z, t_y/t_z clamped to 1.3 tan(fov),
//   T = J W (W = V[:3, :3]^T), cov2d = (T Sigma) T^T + 0.3 I (low-pass);
//   conic = cov2d^-1 where det != 0 (0 elsewhere, and radius 0);
//   radius = ceil(3 sqrt(lambda_max)); the tile rect from the radius, or
//   from the alpha-aware radius where the opacity is given; tiles_touched;
//   rgb = max(SH(deg) at (m - campos)/|m - campos| + 0.5, 0), unless the
//   caller gives the colours.
// The backward recomputes these from the inputs (nothing of the forward is
// kept but its inputs) and differentiates each gaussian as autograd
// differentiates the plain version, culled or not: the x/y clamp's slope is
// 1 inside, 0 outside and 1/2 at a tie (torch.maximum/minimum), the conic's
// gradient is 0 where det == 0, the colour's clamp passes a tie, the two
// normalisations' norm term stops below 1e-12. Each gaussian owns its rows:
// no atomics.
//
// What bounds it on the H100. Bytes: the forward reads 236 and writes 60 a
// gaussian at SH degree 3 with the opacity, the backward reads 268 and
// writes 232; at 300,000 gaussians 0.027 + 0.045 ms at 3.35 TB/s. Some 470
// FP32 operations a gaussian forward (benchmark/work.py::PROJECTION_OPS),
// about twice that backward: 0.002 + 0.004 ms at 67 TFLOP/s. So it is bound
// by bytes, and the plain version's cost was never the arithmetic: ~290
// eager ops and ~240 autograd nodes a view, and batched 2x3 by 3x3 GEMMs
// each padded to a 32 x 32 tile (5.7 ms a stage-1 train step).
//
// Design. One thread a gaussian, 64 a block, everything in registers. The
// SH rows (192 B a gaussian at degree 3) are the one wide read: a warp
// copies its 32 rows' active coefficients into shared memory, lane l
// taking elements l, l + 32, ... of the warp's contiguous span (every load
// of a warp one 128-byte line), and each thread then reads its own row there
// (rows padded to an odd stride: no bank conflicts). The backward writes the
// SH gradient back the same way, zeros beyond the active degree included.
// The camera (39 numbers) is read once a block into shared memory. Templated
// on the SH degree (-1: colours given, 0 to 3); the covariance's source and
// the opacity are branches uniform over a launch.
//
// Precision: float32, the plain version's operations in its order; IEEE
// divides and square roots, logf, no fast-math flags (nvcc may still
// contract a multiply and an add into an FMA, where the plain version's
// GEMMs do too).
//
// Plain C interface (built by nvcc into a shared library, bound with ctypes):
// r3dg_projection_fwd and r3dg_projection_bwd return the first CUDA error,
// or 0.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
// The camera in shared memory: world_view [16], full_proj [16], campos [3],
// focal [2], tan_fov [2].
constexpr int kWv = 0, kFp = 16, kCampos = 32, kFocal = 35, kTanFov = 37;
constexpr int kCam = 39;

// torch.maximum / torch.minimum / torch.clamp(min=...): NaN propagates.
__device__ __forceinline__ float max_(float a, float b) {
  return (a != a || a > b) ? a : (b != b ? b : (a < b ? b : a));
}
__device__ __forceinline__ float min_(float a, float b) {
  return (a != a || a < b) ? a : (b != b ? b : (a > b ? b : a));
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// torch.div(a, b, rounding_mode="floor") for floating a, b.
__device__ __forceinline__ float div_floor(float a, float b) {
  const float mod = fmodf(a, b);
  float div = (a - mod) / b;
  if (mod != 0.0f && (b < 0.0f) != (mod < 0.0f)) div -= 1.0f;
  if (div == 0.0f) return copysignf(0.0f, a / b);
  float fl = floorf(div);
  if (div - fl > 0.5f) fl += 1.0f;
  return fl;
}

// Column j of [x y z 1] @ M for a row-major 4 x 4 M.
__device__ __forceinline__ float affine(const float* M, float x, float y,
                                        float z, int j) {
  return x * M[j] + y * M[4 + j] + z * M[8 + j] + M[12 + j];
}

// The SH constants of utils/sh.py (3DGS's sign convention).
constexpr double kC0 = 0.28209479177387814;
constexpr double kC1 = 0.4886025119029199;
constexpr double kC2_0 = 1.0925484305920792, kC2_1 = -1.0925484305920792,
                 kC2_2 = 0.31539156525252005, kC2_3 = -1.0925484305920792,
                 kC2_4 = 0.5462742152960396;
constexpr double kC3_0 = -0.5900435899266435, kC3_1 = 2.890611442640554,
                 kC3_2 = -0.4570457994644658, kC3_3 = 0.3731763325901154,
                 kC3_4 = -0.4570457994644658, kC3_5 = 1.445305721320277,
                 kC3_6 = -0.5900435899266435;

// utils/sh.py::eval_sh_basis at a unit direction, in its operation order.
template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* b) {
  b[0] = float(kC0);
  if constexpr (DEG > 0) {
    b[1] = float(-kC1) * y;
    b[2] = float(kC1) * z;
    b[3] = float(-kC1) * x;
  }
  if constexpr (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = float(kC2_0) * xy;
    b[5] = float(kC2_1) * yz;
    b[6] = float(kC2_2) * (2.0f * zz - xx - yy);
    b[7] = float(kC2_3) * xz;
    b[8] = float(kC2_4) * (xx - yy);
    if constexpr (DEG > 2) {
      b[9] = float(kC3_0) * y * (3.0f * xx - yy);
      b[10] = float(kC3_1) * xy * z;
      b[11] = float(kC3_2) * y * (4.0f * zz - xx - yy);
      b[12] = float(kC3_3) * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      b[13] = float(kC3_4) * x * (4.0f * zz - xx - yy);
      b[14] = float(kC3_5) * z * (xx - yy);
      b[15] = float(kC3_6) * x * (xx - 3.0f * yy);
    }
  }
}

// d(sum_k w_k basis_k)/d(x, y, z) for weights w.
template <int DEG>
__device__ __forceinline__ void sh_basis_vjp(float x, float y, float z,
                                             const float* w, float* g) {
  g[0] = g[1] = g[2] = 0.0f;
  if constexpr (DEG > 0) {
    g[1] += float(-kC1) * w[1];
    g[2] += float(kC1) * w[2];
    g[0] += float(-kC1) * w[3];
  }
  if constexpr (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    g[0] += float(kC2_0) * y * w[4];
    g[1] += float(kC2_0) * x * w[4];
    g[1] += float(kC2_1) * z * w[5];
    g[2] += float(kC2_1) * y * w[5];
    g[0] += float(-2 * kC2_2) * x * w[6];
    g[1] += float(-2 * kC2_2) * y * w[6];
    g[2] += float(4 * kC2_2) * z * w[6];
    g[0] += float(kC2_3) * z * w[7];
    g[2] += float(kC2_3) * x * w[7];
    g[0] += float(2 * kC2_4) * x * w[8];
    g[1] += float(-2 * kC2_4) * y * w[8];
    if constexpr (DEG > 2) {
      g[0] += float(6 * kC3_0) * x * y * w[9];
      g[1] += float(kC3_0) * (3.0f * xx - 3.0f * yy) * w[9];
      g[0] += float(kC3_1) * y * z * w[10];
      g[1] += float(kC3_1) * x * z * w[10];
      g[2] += float(kC3_1) * x * y * w[10];
      g[0] += float(-2 * kC3_2) * x * y * w[11];
      g[1] += float(kC3_2) * (4.0f * zz - xx - 3.0f * yy) * w[11];
      g[2] += float(8 * kC3_2) * y * z * w[11];
      g[0] += float(-6 * kC3_3) * x * z * w[12];
      g[1] += float(-6 * kC3_3) * y * z * w[12];
      g[2] += float(kC3_3) * (6.0f * zz - 3.0f * xx - 3.0f * yy) * w[12];
      g[0] += float(kC3_4) * (4.0f * zz - 3.0f * xx - yy) * w[13];
      g[1] += float(-2 * kC3_4) * x * y * w[13];
      g[2] += float(8 * kC3_4) * x * z * w[13];
      g[0] += float(2 * kC3_5) * x * z * w[14];
      g[1] += float(-2 * kC3_5) * y * z * w[14];
      g[2] += float(kC3_5) * (xx - yy) * w[14];
      g[0] += float(kC3_6) * (3.0f * xx - 3.0f * yy) * w[15];
      g[1] += float(-6 * kC3_6) * x * y * w[15];
    }
  }
}

// v / max(|v|, 1e-12) of a 3-vector, and that normalisation's backward.
__device__ __forceinline__ float norm3(const float* v) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

template <int N>
__device__ __forceinline__ void normalize_vjp(const float* v, float n,
                                              const float* g, float* out) {
  const float c = clamp_min(n, 1e-12f);
  float dot = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) dot += g[k] * v[k];
  const float g_c = -dot / (c * c);
  const float s = n >= 1e-12f ? g_c / n : 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = g[k] / c + s * v[k];
}

// utils/quaternions.py::quaternion_to_rotmat of a unit (r, x, y, z).
__device__ __forceinline__ void rotmat(const float* q, float* R) {
  const float r = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1.0f - 2.0f * (y * y + z * z);
  R[1] = 2.0f * (x * y - r * z);
  R[2] = 2.0f * (x * z + r * y);
  R[3] = 2.0f * (x * y + r * z);
  R[4] = 1.0f - 2.0f * (x * x + z * z);
  R[5] = 2.0f * (y * z - r * x);
  R[6] = 2.0f * (x * z - r * y);
  R[7] = 2.0f * (y * z + r * x);
  R[8] = 1.0f - 2.0f * (x * x + y * y);
}

// What the covariance's source gives: Sigma [9] row-major, and for scales
// and rotations the normalised quaternion, its norm, R and modifier x scale.
struct Cov3 {
  float sigma[9];
  float qn[4], qnorm, R[9], ss[3];
};

// cov_kind 0: scales and rotations; 6: packed (xx, xy, xz, yy, yz, zz);
// 9: the full matrix as it is.
__device__ __forceinline__ void covariance(const float* scales,
                                           const float* rots, const float* cov,
                                           int cov_kind, float modifier,
                                           int64_t i, Cov3& c) {
  if (cov_kind == 9) {
#pragma unroll
    for (int k = 0; k < 9; ++k) c.sigma[k] = cov[9 * i + k];
    return;
  }
  if (cov_kind == 6) {
    const float* p = cov + 6 * i;
    c.sigma[0] = p[0]; c.sigma[1] = p[1]; c.sigma[2] = p[2];
    c.sigma[3] = p[1]; c.sigma[4] = p[3]; c.sigma[5] = p[4];
    c.sigma[6] = p[2]; c.sigma[7] = p[4]; c.sigma[8] = p[5];
    return;
  }
  const float q[4] = {rots[4 * i], rots[4 * i + 1], rots[4 * i + 2],
                  rots[4 * i + 3]};
  c.qnorm = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float qc = clamp_min(c.qnorm, 1e-12f);
#pragma unroll
  for (int k = 0; k < 4; ++k) c.qn[k] = q[k] / qc;
  rotmat(c.qn, c.R);
#pragma unroll
  for (int k = 0; k < 3; ++k) c.ss[k] = modifier * scales[3 * i + k];
  float L[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) L[3 * r + k] = c.R[3 * r + k] * c.ss[k];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      c.sigma[3 * r + k] = L[3 * r] * L[3 * k] + L[3 * r + 1] * L[3 * k + 1] +
                           L[3 * r + 2] * L[3 * k + 2];
}

// The EWA chain from the view-space point t to the screen covariance
// (ops/projection.py::compute_cov2d), with what the backward reuses.
struct Ewa {
  float ux, uy, cx, cy, tx, ty;   // t_xy / t_z, clamped, times t_z
  float J00, J02, J11, J12;       // J01 = J10 = 0
  float T0[3], T1[3];             // T = J W
  float M0[3], M1[3];             // M = T Sigma
  float xx, xy, yy;               // cov2d + 0.3 I
};

__device__ __forceinline__ void ewa(const float* cam, float t0, float t1,
                                    float tz, const float* sigma, Ewa& e) {
  const float limx = 1.3f * cam[kTanFov], limy = 1.3f * cam[kTanFov + 1];
  e.ux = t0 / tz;
  e.uy = t1 / tz;
  e.cx = min_(max_(e.ux, -limx), limx);
  e.cy = min_(max_(e.uy, -limy), limy);
  e.tx = e.cx * tz;
  e.ty = e.cy * tz;
  const float fx = cam[kFocal], fy = cam[kFocal + 1];
  const float d = tz * tz;
  e.J00 = fx / tz;
  e.J02 = -(fx * e.tx) / d;
  e.J11 = fy / tz;
  e.J12 = -(fy * e.ty) / d;
  const float* V = cam + kWv;     // W[k][c] = V[c][k] = V[4 c + k]
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e.T0[c] = e.J00 * V[4 * c] + e.J02 * V[4 * c + 2];
    e.T1[c] = e.J11 * V[4 * c + 1] + e.J12 * V[4 * c + 2];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e.M0[c] = e.T0[0] * sigma[c] + e.T0[1] * sigma[3 + c] +
              e.T0[2] * sigma[6 + c];
    e.M1[c] = e.T1[0] * sigma[c] + e.T1[1] * sigma[3 + c] +
              e.T1[2] * sigma[6 + c];
  }
  e.xx = (e.M0[0] * e.T0[0] + e.M0[1] * e.T0[1] + e.M0[2] * e.T0[2]) + 0.3f;
  e.xy = e.M0[0] * e.T1[0] + e.M0[1] * e.T1[1] + e.M0[2] * e.T1[2];
  e.yy = (e.M1[0] * e.T1[0] + e.M1[1] * e.T1[1] + e.M1[2] * e.T1[2]) + 0.3f;
}

// d/du of min(max(u, -lim), lim) as autograd takes it.
__device__ __forceinline__ float clamp_slope(float u, float lim) {
  const float inner = u > -lim ? 1.0f : (u == -lim ? 0.5f : 0.0f);
  const float v = max_(u, -lim);
  return inner * (v < lim ? 1.0f : (v == lim ? 0.5f : 0.0f));
}

// Everything a launch reads or writes; absent tensors are null.
struct Args {
  const float* means; const float* scales; const float* rots; const float* shs;
  const float* cov; const float* offset; const float* opacity;
  // world_view, full_proj, campos, focal, tan_fov
  const float* cam[5];
  int64_t P;
  int K, cov_kind, width, height, tile, tiles_x, tiles_y;
  float modifier;
  // forward outputs
  float* mean2d; float* depth; float* conic; float* rgb;
  int* radius; int* rect_min; int* rect_max; int* tiles;
  // backward inputs (null: zero) and outputs (null: not needed)
  const float* g_mean2d; const float* g_depth; const float* g_conic;
  const float* g_rgb;
  float* g_means; float* g_scales; float* g_rots; float* g_shs; float* g_cov;
};

__device__ __forceinline__ void load_camera(const Args& a, float* cam) {
  const int offset[5] = {kWv, kFp, kCampos, kFocal, kTanFov};
  const int count[5] = {16, 16, 3, 2, 2};
#pragma unroll
  for (int s = 0; s < 5; ++s)
    for (int k = threadIdx.x; k < count[s]; k += kThreads)
      cam[offset[s] + k] = a.cam[s][k];
  __syncthreads();
}

// The warp's first gaussian, how many of its 32 exist, and its rows of
// n3 + 1 floats in shared memory.
struct WarpRows {
  int64_t first;
  int n;
  float* rows;
};

template <int N3>
__device__ __forceinline__ WarpRows warp_rows(int64_t P, float* smem) {
  const int warp = threadIdx.x >> 5;
  WarpRows w;
  w.first = static_cast<int64_t>(blockIdx.x) * kThreads + 32 * warp;
  const int64_t left = P - w.first;
  w.n = left <= 0 ? 0 : (left < 32 ? static_cast<int>(left) : 32);
  w.rows = smem + warp * 32 * (N3 + 1);
  return w;
}

// The warp's active SH coefficients, [n][N3] of the [P, K * 3] rows, into
// its shared rows: lane l copies elements l, l + 32, ... of the span.
template <int N3>
__device__ __forceinline__ void stage_sh(const float* __restrict__ shs,
                                         int K3, const WarpRows& w) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < w.n * N3; e += 32) {
    const int r = e / N3, c = e - r * N3;
    w.rows[r * (N3 + 1) + c] = __ldg(shs + (w.first + r) * K3 + c);
  }
  __syncwarp();
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(const Args a) {
  constexpr int N3 = DEG < 0 ? 0 : 3 * (DEG + 1) * (DEG + 1);
  __shared__ float cam[kCam];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  load_camera(a, cam);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  WarpRows w{};
  if constexpr (DEG >= 0) {
    w = warp_rows<N3>(a.P, reinterpret_cast<float*>(smem_raw));
    stage_sh<N3>(a.shs, 3 * a.K, w);
  }
  if (i >= a.P) return;

  const float x = a.means[3 * i], y = a.means[3 * i + 1],
              z = a.means[3 * i + 2];
  const float t0 = affine(cam + kWv, x, y, z, 0);
  const float t1 = affine(cam + kWv, x, y, z, 1);
  const float tz = affine(cam + kWv, x, y, z, 2);
  const float h0 = affine(cam + kFp, x, y, z, 0);
  const float h1 = affine(cam + kFp, x, y, z, 1);
  const float h3 = affine(cam + kFp, x, y, z, 3);
  const float p_w = 1.0f / (h3 + 1e-7f);

  Cov3 c;
  covariance(a.scales, a.rots, a.cov, a.cov_kind, a.modifier, i, c);
  Ewa e;
  ewa(cam, t0, t1, tz, c.sigma, e);

  const float det = e.xx * e.yy - e.xy * e.xy;
  const bool det_ok = det != 0.0f;
  const float inv_det = det_ok ? 1.0f / det : 0.0f;
  const float mid = 0.5f * (e.xx + e.yy);
  const float gap = sqrtf(clamp_min(mid * mid - det, 0.1f));
  const float lambda1 = mid + gap;
  const float radius_f = ceilf(3.0f * sqrtf(clamp_min(lambda1, 0.0f)));

  float m2d[2] = {((h0 * p_w + 1.0f) * float(a.width) - 1.0f) * 0.5f,
              ((h1 * p_w + 1.0f) * float(a.height) - 1.0f) * 0.5f};
  if (a.offset) {
    m2d[0] = m2d[0] + a.offset[2 * i];
    m2d[1] = m2d[1] + a.offset[2 * i + 1];
  }
  // float to int32 truncates toward zero (the card's cvt saturates, NaN to
  // 0), as torch's .to(torch.int32) does there
  int radius = (tz > 0.2f && det_ok) ? static_cast<int>(radius_f) : 0;

  // The tile rect (min inclusive, max exclusive), clamped to the grid.
  const float radius_f32 = static_cast<float>(radius);
  float rect_r = radius_f32;
  if (a.opacity) {
    const float op = clamp_min(a.opacity[i], 0.0f);
    const float r_alpha = ceilf(sqrtf(clamp_min(
        2.0f * lambda1 * logf(clamp_min(op, 1e-12f) * 255.0f), 0.0f)));
    rect_r = op * 255.0f <= 1.0f ? 0.0f : min_(radius_f32, r_alpha);
    rect_r = radius > 0 ? rect_r : 0.0f;
  }
  const float tile = float(a.tile);
  const int grid[2] = {a.tiles_x, a.tiles_y};
  int rmin[2], rmax[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    int lo = static_cast<int>((m2d[k] - rect_r) / tile);
    int hi = static_cast<int>(div_floor(m2d[k] + rect_r + tile - 1.0f, tile));
    lo = lo < 0 ? 0 : lo;
    hi = hi < 0 ? 0 : hi;
    rmin[k] = lo < grid[k] ? lo : grid[k];
    rmax[k] = hi < grid[k] ? hi : grid[k];
  }
  const int sx = rmax[0] - rmin[0], sy = rmax[1] - rmin[1];
  const int touched = radius > 0 ? (sx < 0 ? 0 : sx) * (sy < 0 ? 0 : sy) : 0;
  radius = touched > 0 ? radius : 0;

  a.mean2d[2 * i] = m2d[0];
  a.mean2d[2 * i + 1] = m2d[1];
  a.depth[i] = tz;
  a.conic[3 * i] = e.yy * inv_det;
  a.conic[3 * i + 1] = -e.xy * inv_det;
  a.conic[3 * i + 2] = e.xx * inv_det;
  a.radius[i] = radius;
  a.rect_min[2 * i] = rmin[0];
  a.rect_min[2 * i + 1] = rmin[1];
  a.rect_max[2 * i] = rmax[0];
  a.rect_max[2 * i + 1] = rmax[1];
  a.tiles[i] = touched;

  if constexpr (DEG >= 0) {
    const float v[3] = {x - cam[kCampos], y - cam[kCampos + 1],
                    z - cam[kCampos + 2]};
    const float n = clamp_min(norm3(v), 1e-12f);
    float b[N3 / 3];
    sh_basis<DEG>(v[0] / n, v[1] / n, v[2] / n, b);
    const float* row = w.rows + (threadIdx.x & 31) * (N3 + 1);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float acc = b[0] * row[ch];
#pragma unroll
      for (int k = 1; k < N3 / 3; ++k) acc += b[k] * row[3 * k + ch];
      a.rgb[3 * i + ch] = clamp_min(acc + 0.5f, 0.0f);
    }
  }
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(const Args a) {
  constexpr int N3 = DEG < 0 ? 0 : 3 * (DEG + 1) * (DEG + 1);
  __shared__ float cam[kCam];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  load_camera(a, cam);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool valid = i < a.P;
  WarpRows w{};
  if constexpr (DEG >= 0) {
    w = warp_rows<N3>(a.P, reinterpret_cast<float*>(smem_raw));
    stage_sh<N3>(a.shs, 3 * a.K, w);
  }
  float g_m[3] = {0.0f, 0.0f, 0.0f};
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (valid) {
    x = a.means[3 * i]; y = a.means[3 * i + 1]; z = a.means[3 * i + 2];
    const float t0 = affine(cam + kWv, x, y, z, 0);
    const float t1 = affine(cam + kWv, x, y, z, 1);
    const float tz = affine(cam + kWv, x, y, z, 2);
    const float h0 = affine(cam + kFp, x, y, z, 0);
    const float h1 = affine(cam + kFp, x, y, z, 1);
    const float h3 = affine(cam + kFp, x, y, z, 3);
    const float p_w = 1.0f / (h3 + 1e-7f);

    // mean2d: ((h_j p_w + 1) size - 1) / 2
    const float* F = cam + kFp;
    if (a.g_mean2d) {
      const float g_p0 = a.g_mean2d[2 * i] * 0.5f * float(a.width);
      const float g_p1 = a.g_mean2d[2 * i + 1] * 0.5f * float(a.height);
      const float g_pw = g_p0 * h0 + g_p1 * h1;
      const float g_h0 = g_p0 * p_w, g_h1 = g_p1 * p_w;
      const float g_h3 = -g_pw * p_w * p_w;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        g_m[k] = g_h0 * F[4 * k] + g_h1 * F[4 * k + 1] + g_h3 * F[4 * k + 3];
    }

    Cov3 c;
    covariance(a.scales, a.rots, a.cov, a.cov_kind, a.modifier, i, c);
    Ewa e;
    ewa(cam, t0, t1, tz, c.sigma, e);

    // conic = (yy, -xy, xx) / det where det != 0
    float g_xx = 0.0f, g_xy = 0.0f, g_yy = 0.0f;
    const float det = e.xx * e.yy - e.xy * e.xy;
    if (a.g_conic && det != 0.0f) {
      const float inv = 1.0f / det;
      const float ga = a.g_conic[3 * i], gb = a.g_conic[3 * i + 1],
              gc = a.g_conic[3 * i + 2];
      const float g_inv = ga * e.yy - gb * e.xy + gc * e.xx;
      const float g_det = -g_inv * inv * inv;
      g_xx = gc * inv + g_det * e.yy;
      g_yy = ga * inv + g_det * e.xx;
      g_xy = -gb * inv - g_det * 2.0f * e.xy;
    }
    // cov2d = M T^T, M = T Sigma, with G = [[g_xx, g_xy], [0, g_yy]]:
    // g_M = G T, g_T = G^T M + g_M Sigma^T, g_Sigma = T^T g_M.
    float g_M0[3], g_M1[3], g_T0[3], g_T1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_M0[k] = g_xx * e.T0[k] + g_xy * e.T1[k];
      g_M1[k] = g_yy * e.T1[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_T0[k] = g_xx * e.M0[k] + g_M0[0] * c.sigma[3 * k] +
                g_M0[1] * c.sigma[3 * k + 1] + g_M0[2] * c.sigma[3 * k + 2];
      g_T1[k] = g_xy * e.M0[k] + g_yy * e.M1[k] + g_M1[0] * c.sigma[3 * k] +
                g_M1[1] * c.sigma[3 * k + 1] + g_M1[2] * c.sigma[3 * k + 2];
    }
    float g_sigma[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        g_sigma[3 * r + k] = e.T0[r] * g_M0[k] + e.T1[r] * g_M1[k];

    // T = J W: g_J[a][k] = sum_c g_T[a][c] W[k][c], W[k][c] = V[4 c + k]
    const float* V = cam + kWv;
    float g_J00 = 0.0f, g_J02 = 0.0f, g_J11 = 0.0f, g_J12 = 0.0f;
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      g_J00 += g_T0[cc] * V[4 * cc];
      g_J02 += g_T0[cc] * V[4 * cc + 2];
      g_J11 += g_T1[cc] * V[4 * cc + 1];
      g_J12 += g_T1[cc] * V[4 * cc + 2];
    }
    const float fx = cam[kFocal], fy = cam[kFocal + 1];
    const float d = tz * tz;
    const float g_nx = g_J02 / d, g_ny = g_J12 / d;
    const float g_d = -g_J02 * (-(fx * e.tx)) / (d * d) -
                  g_J12 * (-(fy * e.ty)) / (d * d);
    const float g_tx = -g_nx * fx, g_ty = -g_ny * fy;
    float g_tz = g_J00 * (-fx / d) + g_J11 * (-fy / d) + g_d * 2.0f * tz +
             g_tx * e.cx + g_ty * e.cy;
    if (a.g_depth) g_tz += a.g_depth[i];
    const float limx = 1.3f * cam[kTanFov], limy = 1.3f * cam[kTanFov + 1];
    const float g_ux = g_tx * tz * clamp_slope(e.ux, limx);
    const float g_uy = g_ty * tz * clamp_slope(e.uy, limy);
    g_tz = g_tz - g_ux * t0 / d - g_uy * t1 / d;
    const float g_t0 = g_ux / tz, g_t1 = g_uy / tz;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      g_m[k] += g_t0 * V[4 * k] + g_t1 * V[4 * k + 1] + g_tz * V[4 * k + 2];

    if (a.cov_kind == 9) {
      if (a.g_cov) {
#pragma unroll
        for (int k = 0; k < 9; ++k) a.g_cov[9 * i + k] = g_sigma[k];
      }
    } else if (a.cov_kind == 6) {
      if (a.g_cov) {
        float* p = a.g_cov + 6 * i;
        p[0] = g_sigma[0];
        p[1] = g_sigma[1] + g_sigma[3];
        p[2] = g_sigma[2] + g_sigma[6];
        p[3] = g_sigma[4];
        p[4] = g_sigma[5] + g_sigma[7];
        p[5] = g_sigma[8];
      }
    } else {
      // Sigma = L L^T, L = R diag(ss): g_L = (g_Sigma + g_Sigma^T) L
      float L[9], g_L[9];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k) L[3 * r + k] = c.R[3 * r + k] * c.ss[k];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float acc = 0.0f;
#pragma unroll
          for (int cc = 0; cc < 3; ++cc)
            acc += (g_sigma[3 * r + cc] + g_sigma[3 * cc + r]) * L[3 * cc + k];
          g_L[3 * r + k] = acc;
        }
      if (a.g_scales) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          a.g_scales[3 * i + k] = (g_L[k] * c.R[k] + g_L[3 + k] * c.R[3 + k] +
                                   g_L[6 + k] * c.R[6 + k]) * a.modifier;
      }
      if (a.g_rots) {
        float g[9];
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int k = 0; k < 3; ++k) g[3 * r + k] = g_L[3 * r + k] * c.ss[k];
        const float r = c.qn[0], qx = c.qn[1], qy = c.qn[2], qz = c.qn[3];
        const float g_qn[4] = {
            2.0f * (-qz * g[1] + qy * g[2] + qz * g[3] - qx * g[5] -
                    qy * g[6] + qx * g[7]),
            2.0f * (qy * g[1] + qz * g[2] + qy * g[3] - 2.0f * qx * g[4] -
                    r * g[5] + qz * g[6] + r * g[7] - 2.0f * qx * g[8]),
            2.0f * (-2.0f * qy * g[0] + qx * g[1] + r * g[2] + qx * g[3] +
                    qz * g[5] - r * g[6] + qz * g[7] - 2.0f * qy * g[8]),
            2.0f * (-2.0f * qz * g[0] - r * g[1] + qx * g[2] + r * g[3] -
                    2.0f * qz * g[4] + qy * g[5] + qx * g[6] + qy * g[7])};
        const float q[4] = {a.rots[4 * i], a.rots[4 * i + 1], a.rots[4 * i + 2],
                        a.rots[4 * i + 3]};
        float g_q[4];
        normalize_vjp<4>(q, c.qnorm, g_qn, g_q);
#pragma unroll
        for (int k = 0; k < 4; ++k) a.g_rots[4 * i + k] = g_q[k];
      }
    }
  }

  if constexpr (DEG >= 0) {
    // rgb = max(sum_k basis_k sh_k + 0.5, 0); the gradient of the SH row
    // replaces the coefficients in the warp's shared row, then the warp
    // writes its span of [P, K * 3], zeros beyond the active degree.
    float* row = w.rows + (threadIdx.x & 31) * (N3 + 1);
    if (valid) {
      const float v[3] = {x - cam[kCampos], y - cam[kCampos + 1],
                      z - cam[kCampos + 2]};
      const float n = norm3(v);
      const float cn = clamp_min(n, 1e-12f);
      const float dx = v[0] / cn, dy = v[1] / cn, dz = v[2] / cn;
      float b[N3 / 3];
      sh_basis<DEG>(dx, dy, dz, b);
      float g_raw[3] = {0.0f, 0.0f, 0.0f};
      if (a.g_rgb) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          float acc = b[0] * row[ch];
#pragma unroll
          for (int k = 1; k < N3 / 3; ++k) acc += b[k] * row[3 * k + ch];
          g_raw[ch] = acc + 0.5f >= 0.0f ? a.g_rgb[3 * i + ch] : 0.0f;
        }
      }
      float wk[N3 / 3];
#pragma unroll
      for (int k = 0; k < N3 / 3; ++k)
        wk[k] = row[3 * k] * g_raw[0] + row[3 * k + 1] * g_raw[1] +
                row[3 * k + 2] * g_raw[2];
      float g_dir[3], g_v[3];
      sh_basis_vjp<DEG>(dx, dy, dz, wk, g_dir);
      normalize_vjp<3>(v, n, g_dir, g_v);
#pragma unroll
      for (int k = 0; k < 3; ++k) g_m[k] += g_v[k];
#pragma unroll
      for (int k = 0; k < N3 / 3; ++k)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) row[3 * k + ch] = b[k] * g_raw[ch];
    }
    if (a.g_shs) {
      __syncwarp();
      const int lane = threadIdx.x & 31;
      const int K3 = 3 * a.K;
      float* out = a.g_shs + w.first * K3;
      for (int el = lane; el < w.n * K3; el += 32) {
        const int r = el / K3, cc = el - r * K3;
        out[el] = cc < N3 ? w.rows[r * (N3 + 1) + cc] : 0.0f;
      }
    }
  }
  if (valid && a.g_means) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a.g_means[3 * i + k] = g_m[k];
  }
}

template <int DEG>
cudaError_t launch(const Args& a, bool backward, cudaStream_t stream) {
  constexpr int N3 = DEG < 0 ? 0 : 3 * (DEG + 1) * (DEG + 1);
  const size_t smem = DEG < 0 ? 0 : sizeof(float) * kWarps * 32 * (N3 + 1);
  const unsigned blocks =
      static_cast<unsigned>((a.P + kThreads - 1) / kThreads);
  if (backward)
    project_bwd_kernel<DEG><<<blocks, kThreads, smem, stream>>>(a);
  else
    project_fwd_kernel<DEG><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, int deg, bool backward,
                     cudaStream_t stream) {
  switch (deg) {
    case -1: return launch<-1>(a, backward, stream);
    case 0: return launch<0>(a, backward, stream);
    case 1: return launch<1>(a, backward, stream);
    case 2: return launch<2>(a, backward, stream);
    case 3: return launch<3>(a, backward, stream);
    default: return cudaErrorInvalidValue;
  }
}

Args args_of(const void* means, const void* scales, const void* rots,
             const void* shs, const void* cov, const void* const cam[5],
             int64_t P, int K, int cov_kind, int width, int height,
             float modifier) {
  Args a{};
  a.means = static_cast<const float*>(means);
  a.scales = static_cast<const float*>(scales);
  a.rots = static_cast<const float*>(rots);
  a.shs = static_cast<const float*>(shs);
  a.cov = static_cast<const float*>(cov);
  for (int s = 0; s < 5; ++s) a.cam[s] = static_cast<const float*>(cam[s]);
  a.P = P;
  a.K = K;
  a.cov_kind = cov_kind;
  a.width = width;
  a.height = height;
  a.modifier = modifier;
  return a;
}

bool valid_layout(int64_t P, int K, int deg, int cov_kind) {
  return P > 0 && P <= int64_t(2147483647) * kThreads && deg >= -1 &&
         deg <= 3 && (deg < 0 || K >= (deg + 1) * (deg + 1)) &&
         (cov_kind == 0 || cov_kind == 6 || cov_kind == 9);
}

}  // namespace

// K7's forward: P gaussians (scales and rotations, or cov3d_precomp of
// cov_kind 6 or 9; shs [P, K, 3] at degree deg, or deg -1 for colours
// given; offset and opacity optional) on the camera's five tensors, all
// float32, into mean2d [P, 2], depth [P], conic [P, 3], rgb [P, 3]
// (deg >= 0), and int32 radius [P], rect_min and rect_max [P, 2],
// tiles_touched [P].
extern "C" int r3dg_projection_fwd(
    const void* means, const void* scales, const void* rots, const void* shs,
    const void* cov, const void* offset, const void* opacity,
    const void* world_view, const void* full_proj, const void* campos,
    const void* focal, const void* tan_fov, int64_t P, int K, int deg,
    int cov_kind, int width, int height, int tile, int tiles_x, int tiles_y,
    float scale_modifier, void* mean2d, void* depth, void* conic, void* rgb,
    void* radius, void* rect_min, void* rect_max, void* tiles_touched,
    void* stream) {
  if (!valid_layout(P, K, deg, cov_kind) || tile < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const cam[5] = {world_view, full_proj, campos, focal, tan_fov};
  Args a = args_of(means, scales, rots, shs, cov, cam, P, K, cov_kind, width,
                   height, scale_modifier);
  a.offset = static_cast<const float*>(offset);
  a.opacity = static_cast<const float*>(opacity);
  a.tile = tile;
  a.tiles_x = tiles_x;
  a.tiles_y = tiles_y;
  a.mean2d = static_cast<float*>(mean2d);
  a.depth = static_cast<float*>(depth);
  a.conic = static_cast<float*>(conic);
  a.rgb = static_cast<float*>(rgb);
  a.radius = static_cast<int*>(radius);
  a.rect_min = static_cast<int*>(rect_min);
  a.rect_max = static_cast<int*>(rect_max);
  a.tiles = static_cast<int*>(tiles_touched);
  return static_cast<int>(
      dispatch(a, deg, false, static_cast<cudaStream_t>(stream)));
}

// K7's backward: the forward's inputs and the gradients of mean2d, depth,
// conic and rgb (null: zero) into the gradients of the means, scales,
// rotations, SH rows (all K coefficients) and cov3d_precomp (null: not
// wanted), all float32.
extern "C" int r3dg_projection_bwd(
    const void* means, const void* scales, const void* rots, const void* shs,
    const void* cov, const void* world_view, const void* full_proj,
    const void* campos, const void* focal, const void* tan_fov,
    const void* g_mean2d, const void* g_depth, const void* g_conic,
    const void* g_rgb, int64_t P, int K, int deg, int cov_kind, int width,
    int height, float scale_modifier, void* g_means, void* g_scales,
    void* g_rots, void* g_shs, void* g_cov, void* stream) {
  if (!valid_layout(P, K, deg, cov_kind))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const cam[5] = {world_view, full_proj, campos, focal, tan_fov};
  Args a = args_of(means, scales, rots, shs, cov, cam, P, K, cov_kind, width,
                   height, scale_modifier);
  a.g_mean2d = static_cast<const float*>(g_mean2d);
  a.g_depth = static_cast<const float*>(g_depth);
  a.g_conic = static_cast<const float*>(g_conic);
  a.g_rgb = static_cast<const float*>(g_rgb);
  a.g_means = static_cast<float*>(g_means);
  a.g_scales = static_cast<float*>(g_scales);
  a.g_rots = static_cast<float*>(g_rots);
  a.g_shs = static_cast<float*>(g_shs);
  a.g_cov = static_cast<float*>(g_cov);
  return static_cast<int>(
      dispatch(a, deg, true, static_cast<cudaStream_t>(stream)));
}

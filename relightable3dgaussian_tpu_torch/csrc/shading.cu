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
//     The same quantities, better conditioned. Likewise the half vector
//     h0 = (d + V) / 2 adds V's float32 rounding error back (kept per
//     point from float64): at a sample d near -V it cancels, and V's
//     rounding alone moved the view-direction gradient by up to ~1.6e-4
//     of its largest entry on a trained stage-2 model. And where the local
//     light e is within float32's rounding of 0, the backward takes
//     max(e, 0)'s branch from e in float64 (light64): float32's sign moved
//     one point's SH gradient by ~2e-3.
//
// Every float32 branch of the chain, where K4 could decide otherwise than
// the plain version in float64 (line numbers in this file; chip_smoke.py's
// k4-branches phase forces the four lower clips at 1e-6 (1 + delta),
// examples/k4_conditioning.py sweeps them, examples/k4_grazing.py sets
// views within 2e-6 of grazing):
//   * decided from float64. The value is continuous across each clip, so
//     the arithmetic stays float32; only the branch is taken from float64:
//       max(e, 0) of the local light (above; :851, marked :852,
//         corrected in shade_bwd_fix_kernel :1039).
//       sign(V.N) (:415, in load_point, so forward, backward and fix-up
//         alike): V and N normalised in double and dotted in double, N
//         zeroed only where that dot is exactly 0, as the reference zeroes
//         it. Where float32's sign was 0 or the other one, K4 shaded another
//         function: a view-direction gradient of 10.81 against 0.0013.
//       NoV's lower clip, mask :675, from the same double dot (:417):
//         NoV = |V.N|. A few double operations a point. The jump it
//         decides, gnom1 (1 - k) into V, was ~6e-2 of the view gradient's
//         largest entry.
//       q = 4 pi nom0^2 nom1 nom2, the GGX denominator (clip :474, mask
//         :861), and VoH (clip :453, mask :862): a sample whose float32
//         operand lies within its band about 1e-6 (in_band :621) puts its
//         point on the list (:858), and shade_bwd_fix_kernel recomputes
//         the sample's h and q in double and VoH's decision past double
//         (clips64 :569) and corrects the gradients where either decision
//         differs from float32's (backward only). q
//         reaches 1e-6 near the specular peak
//         where r < ~0.17 (at r = 0.2 q stays above ~1.0e-6); its jump,
//         -f_s dq / q, is all of the sample's roughness and view-direction
//         gradient through q (~1 of those fields' largest entry on the
//         forced points). VoH reaches it a few 1e-4 off the opposite of the
//         view where |d| > 1 (VoH = (1 + V.d) / |d + V|); it jumps ~1e-4 of
//         the view gradient's largest entry. There 1 + V.d cancels to
//         ~3e-10: float64's own VoH is within ~8e-6 of 1e-6 of the exact
//         value, so two float64 evaluations could decide a sample forced
//         within 1e-5 of the clip each their own way. So VoH's decision is
//         taken in double-double (voh_passes :552), whose error is ~1e-22
//         against the 3e-10: the exact decision on the float32 inputs.
//     The bands, from the float32 error of each operand (u = 2^-24). v, ns
//     and h are each within ~4.5u of float64's unit vectors (a sum of
//     squares, a square root and a division; h0 = (d + V) / 2 keeps V's
//     rounding, see above), and a dot of two of them adds 2u (two FMAs):
//       VoH: |v.h - V.H| <= 4.5u + 4.5u + 2u ~ 11u = 6.6e-7; band 2e-6.
//       q: its relative error is at most 2 e0 + e1 + e2 + 4u (four
//         products). nom1 and nom2 are at least k >= 1/8 and NoV, NoL are
//         within 11u, so e1, e2 <= 11u (1 - k) / k + 2u < 80u. nom0 =
//         |ns x h|^2 + NoH^2 alpha^2, with |ns x h| within 12u and NoH
//         within 11u, so e0 <= 24u |ns x h| / nom0 + 26u; at q = 1e-6,
//         nom0 >= (1e-6 / (4 pi))^(1/2) = 2.8e-4 and |ns x h|^2 <= nom0,
//         so e0 <= 24u / 0.0168 + 26u < 1460u. In all q is within ~3100u
//         = 1.8e-4 of itself; band 5e-4 of 1e-6 (kQBand).
//     The records put a floor under the bands: before them, K4's q went
//     apart from float64 on 3-6 of 2000 forced samples at |delta| = 1e-5,
//     its VoH on 425-451 (PERF.md). A trained model puts few samples in
//     either band. The double branch inline in the sample loop, as a call
//     to clips64 or inlined, took K4-bwd from 0.31-0.35 ms a launch to
//     0.41-0.46 and 0.43-0.49 at 101,675 points x 64 samples on an H100
//     (ptxas: 260 and 316 bytes spilled against 48): its code pushed the
//     loop's state out of registers. So the loop only marks the sample,
//     and the fix-up launch, which already lists points and recomputes a
//     listed point's samples, takes the decisions.
//   * left in float32: NoH's lower clip (:452, mask :646, and the
//     cross-product branch :462, continuous: |ns x h|^2 = 1 - NoH^2
//     there). Its jump, 2 NoH gnom0 (alpha^2 - 1), carries the factor
//     NoH = 1e-6: K4 measured <= 5.5e-7 of the largest entry there.
//   * value only, no gradient crosses them: NoL's clip :451 (N and
//     the sample are constants), max(n.d, 0) in the transport (:606,
//     :988), and the upper clips of NoV, NoH and VoH at 1, which dot
//     products of unit vectors pass only by rounding: unmasked, where the
//     plain version's torch.clamp passes all the gradient at the tie and
//     JAX's jnp.clip half; at the tie the gradient projected onto the
//     sphere is 0 (tests/test_torch_shading.py).
//   * unreachable: q's upper clip 4 pi needs nom0 = nom1 = nom2 = 1, i.e.
//     NoV = NoL = 1 with NoH <= 1e-6 (NoV = NoL = 1 puts H on N), or r = 1,
//     past the roughness activation's 0.99. The 1e-12 floors of |V|
//     (:398, :400, :682), |N| (:407) and |h0| (:446,
//     :653) need a zero-length view direction or normal, or a sample
//     opposite the view to 1e-12, which float32's grid meets only when both
//     are exactly on it (an axis-aligned view); such inputs are not forced.
// The plain PyTorch version (ops/shading.py) stays the float32 chain that is
// held to JAX on the CPU: it decides every branch in float32.
// The backward recomputes the forward chain, as the TPU kernel does, and
// returns the analytic VJP for base colour, roughness, view direction, the
// local-light SH and the per-sample global light (dgl [P, S, 3]); torch chains
// dgl into the env map through grid_sample's backward. Normals, visibility,
// directions and areas are constants of the train step and get no gradient.
// IEEE divides and square roots, exp2f; no fast-math flags and no approximate
// intrinsics. Where a sample divided by one value more than once (the half
// vector by its length, f_s and its gradients by the GGX denominator) it
// takes one IEEE reciprocal and multiplies.
//
// What bounds it on the H100. Per (point, sample) the forward reads 32 bytes
// ([P, S, 3] dirs and global light, [P, S] visibility and area) and issues
// some 200 instructions (the SH basis and its 48 FMAs, the GGX chain with a
// square root, two reciprocals and exp2f); the backward also writes 12 bytes
// of dgl and issues about twice the forward's arithmetic, 48 more FMAs into
// the SH gradients among it. At the main path's P ~ 101.7k, S = 64 the bytes
// take 0.070 / 0.100 ms at 3.35 TB/s, the instructions less at the card's
// issue rate. The first design (one warp per point) took 3.9x (forward) and
// 9.2x (backward) those bounds in a stage-2 step on an H100 80GB HBM3 at
// 700 W: every lane repeated the point's set-up for two samples and loaded
// them with nothing in flight, and the backward finished 57 sums with full
// 5-step warp butterflies, its epilogue on one lane, while 48 SH
// accumulators beside the sample state held 186 registers a thread.
// Now the forward is held by its staging: the same pipeline with the shading
// taken out runs nearly as long as the whole forward, and neither deeper
// pipelines (3 and 4 stages), longer runs (32 samples), nor smaller blocks
// shortened it. The backward is held by the latency of its long
// per-sample chain at 4 blocks an SM (128 registers, a few spilled): more
// registers and fewer blocks, or two samples a lane interleaved, ran no
// faster, and stores of dgl straight from registers ran slower than the
// staged stores below.
//
// Design. A 128-thread block owns kPoints = 32 consecutive points, a group of
// kGroup = 4 lanes each; lane g of a group takes samples g, g + 4, ... (16 a
// lane at S = 64), so the point's set-up runs on 4 lanes and its sums need
// 2 butterfly steps. Every per-sample array of the block's points is staged
// in shared memory kChunk = 16 samples at a time, in kStages = 2 buffers:
// chunk c + 1's copies (cp.async, cp_async.cuh; 16-byte copies cached in L2
// only, the data being read once) are in flight while the block computes
// chunk c. Each point's run of a chunk lands in its row at the 16-byte phase
// it has in device memory, so the quads of the run are 16-byte copies
// whatever S or the tensors' storage offsets, and the at most 3 floats at
// either end are 4-byte copies; nothing is refused and nothing falls back.
// Rows of 52 and 20 floats put a warp's 8 points on distinct banks; the
// group's 4 lanes read 4 consecutive samples. The 48 SH coefficients of a
// point are staged once, in a 16-byte aligned row, and read as 12 broadcast
// float4 loads a sample. The forward's 6 sums finish in one reduce-scatter
// over the group (composite_warp.cuh's scatter_step: 6 shuffles), after
// which lane c < 3 writes channel c. The backward keeps 57 per-lane sums (48
// SH gradients, 3 diffuse, 6 GGX terms); one reduce-scatter over the group
// (48 shuffles) leaves lanes 0-2 with 16 SH gradients each, which they store,
// and lane 3 with the other 9, from which it computes d base colour,
// d roughness and d view direction. It evaluates the SH basis twice a
// sample, for the light and again for the SH gradients, so the basis is not
// live across the GGX chain beside the 57 sums. dgl is written into the
// chunk's global-light row in shared memory, which the lane has just read,
// and leaves it a warp a row, 32 consecutive floats a store. Shared memory
// is 43,520 bytes a block, under the 48 KB of static shared memory, so no
// attribute is set: 5 blocks an SM by shared memory; the launch bounds ask
// ptxas for registers that keep 5 (forward) and 4 (backward) blocks resident.
//
// The branches taken from float64 per sample: the backward's lanes mark a
// sample whose |e_c| is below kSignTol sum_k |shs_kc| (the bound sits in the
// SH row's padding), or whose q or VoH lies in its band about 1e-6
// (in_band); a point with one goes on a list (a count and the points, kept
// by the caller), and shade_bwd_fix_kernel, launched after, corrects those
// points' gradients on a warp each. Marking is a few compares a sample; a
// trained stage-2 model lists few points, so the second launch is short.
//
// Plain C interface (built by nvcc into a shared library, bound with ctypes):
// r3dg_shade_fwd and r3dg_shade_bwd return the first CUDA error, or 0.

#include <cstdint>

#include <cuda_runtime.h>

#include "composite_warp.cuh"
#include "cp_async.cuh"

namespace {

constexpr int kGroup = 4;                    // lanes per point
constexpr int kPoints = 32;                  // points per block
constexpr int kThreads = kGroup * kPoints;   // 128
constexpr int kChunk = 16;                   // samples per point a stage
constexpr int kStages = 2;                   // chunk buffers
constexpr int kSH = 16;                      // degree-3 SH coefficients
constexpr int kSHC = 3 * kSH;                // [16, 3] per point
// Row lengths in floats: a run plus its phase (up to 3 floats), rounded to
// 16 bytes, and spread so a warp's 8 points fall on distinct banks.
constexpr int kRow3 = 3 * kChunk + 4;        // dirs, global light: 52
constexpr int kRow1 = kChunk + 4;            // visibility, area: 20
constexpr int kRowSH = kSHC + 4;             // SH coefficients: 52
constexpr float kPi = 3.14159265358979323846f;
constexpr float k4Pi = 4.f * kPi;
constexpr float kFresnel = 0.04f;
constexpr float kLn2 = 0.69314718055994530942f;

struct Stage {
  float dirs[kPoints * kRow3];
  float light[kPoints * kRow3];   // global light; K4-bwd writes dgl over it
  float vis[kPoints * kRow1];
  float area[kPoints * kRow1];
};

struct Smem {
  Stage stage[kStages];
  float shs[kPoints * kRowSH];
};

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ bool inside(float x, float lo, float hi) {
  return x >= lo && x <= hi;
}

// The 16-byte phase of a float's address, in floats (0..3).
__device__ __forceinline__ int phase(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// This thread's share of the copies of n_runs runs of n <= NMAX floats, run r
// from src + r * stride into row r of dst (ROW floats a row, 16-byte aligned)
// at the run's phase: quads inside the run as 16-byte copies, the ends as
// 4-byte copies.
template <int ROW, int NMAX>
__device__ __forceinline__ void stage_runs(float* dst, const float* src,
                                           size_t stride, int n_runs, int n,
                                           int tid) {
  constexpr int kQuads = (NMAX + 6) / 4;     // quads a run can touch
  for (int u = tid; u < n_runs * kQuads; u += kThreads) {
    const int r = u / kQuads, q = u - r * kQuads;
    const float* run = src + r * stride;
    const int ph = phase(run);
    const int lo = max(4 * q, ph), hi = min(4 * q + 4, ph + n);
    float* row = dst + r * ROW;
    if (lo == 4 * q && hi == 4 * q + 4) {
      r3dg::cp_async_stream16(row + lo, run + (lo - ph));
    } else {
      for (int e = lo; e < hi; ++e) r3dg::cp_async<4>(row + e, run + (e - ph));
    }
  }
}

// The block's SH rows: 48 floats a point at phase 0 of its row, 16-byte
// copies where the source is 16-byte aligned (rows lie 192 bytes apart, so
// all are or none is).
__device__ __forceinline__ void stage_shs(float* dst, const float* shs,
                                          int n_pts, int tid) {
  const bool aligned = phase(shs) == 0;
  for (int u = tid; u < n_pts * (kSHC / 4); u += kThreads) {
    const int r = u / (kSHC / 4), q = u - r * (kSHC / 4);
    const float* s = shs + static_cast<size_t>(r) * kSHC + 4 * q;
    float* d = dst + r * kRowSH + 4 * q;
    if (aligned) {
      r3dg::cp_async_stream16(d, s);
    } else {
      for (int e = 0; e < 4; ++e) r3dg::cp_async<4>(d + e, s + e);
    }
  }
}

// Where one chunk of the block's samples comes from.
struct Source {
  const float* dirs;   // [P, S, 3]
  const float* vis;    // [P, S]
  const float* area;   // [P, S]
  const float* gl;     // [P, S, 3]
  int S;
};

// Issues the copies of samples [c0, c0 + n) of points [p0, p0 + n_pts).
__device__ __forceinline__ void stage_chunk(Stage& st, const Source& src,
                                            int p0, int n_pts, int c0, int n,
                                            int tid) {
  const size_t s1 = static_cast<size_t>(p0) * src.S + c0;
  const size_t S = src.S;
  stage_runs<kRow3, 3 * kChunk>(st.dirs, src.dirs + 3 * s1, 3 * S, n_pts,
                                3 * n, tid);
  stage_runs<kRow3, 3 * kChunk>(st.light, src.gl + 3 * s1, 3 * S, n_pts,
                                3 * n, tid);
  stage_runs<kRow1, kChunk>(st.vis, src.vis + s1, S, n_pts, n, tid);
  stage_runs<kRow1, kChunk>(st.area, src.area + s1, S, n_pts, n, tid);
}

// Stages chunk ch (if there is one) into its buffer and commits the copies
// as one group, empty past the last chunk: every thread commits one group a
// chunk, so waiting for all but the newest kStages - 1 groups waits for
// chunk ch - kStages + 1.
__device__ __forceinline__ void stage_ahead(Smem& sm, const Source& src,
                                            int p0, int n_pts, int ch,
                                            int tid) {
  const int c0 = ch * kChunk;
  if (c0 < src.S)
    stage_chunk(sm.stage[ch % kStages], src, p0, n_pts, c0,
                min(kChunk, src.S - c0), tid);
  r3dg::cp_async_commit();
}

// One point's rows in a stage, at the phases its runs landed at.
struct Rows {
  const float* dirs;
  float* light;                   // K4-bwd writes dgl here
  const float* vis;
  const float* area;
};

__device__ __forceinline__ Rows point_rows(Stage& st, const Source& src,
                                           int p, int pt, int c0) {
  const size_t s1 = static_cast<size_t>(p) * src.S + c0;
  return {st.dirs + pt * kRow3 + phase(src.dirs + 3 * s1),
          st.light + pt * kRow3 + phase(src.gl + 3 * s1),
          st.vis + pt * kRow1 + phase(src.vis + s1),
          st.area + pt * kRow1 + phase(src.area + s1)};
}

// Degree-3 real SH basis, in utils/sh.py order and sign convention. Each
// constant rounds to the same float whether written as a float or as a
// double literal.
template <typename T>
__device__ __forceinline__ void sh_basis(T x, T y, T z, T* b) {
  const T xx = x * x, yy = y * y, zz = z * z;
  const T xy = x * y, yz = y * z, xz = x * z;
  b[0] = T(0.28209479177387814);
  b[1] = T(-0.4886025119029199) * y;
  b[2] = T(0.4886025119029199) * z;
  b[3] = T(-0.4886025119029199) * x;
  b[4] = T(1.0925484305920792) * xy;
  b[5] = T(-1.0925484305920792) * yz;
  b[6] = T(0.31539156525252005) * (T(2) * zz - xx - yy);
  b[7] = T(-1.0925484305920792) * xz;
  b[8] = T(0.5462742152960396) * (xx - yy);
  b[9] = T(-0.5900435899266435) * y * (T(3) * xx - yy);
  b[10] = T(2.890611442640554) * xy * z;
  b[11] = T(-0.4570457994644658) * y * (T(4) * zz - xx - yy);
  b[12] = T(0.3731763325901154) * z * (T(2) * zz - T(3) * xx - T(3) * yy);
  b[13] = T(-0.4570457994644658) * x * (T(4) * zz - xx - yy);
  b[14] = T(1.445305721320277) * z * (xx - yy);
  b[15] = T(-0.5900435899266435) * x * (xx - T(3) * yy);
}

// e_c = sum_k basis_k shs[k, c] from a 16-byte aligned SH row (12 float4s).
__device__ __forceinline__ void sh_light(const float* basis,
                                         const float* shs_row, float* e) {
  const float4* row = reinterpret_cast<const float4*>(shs_row);
  e[0] = e[1] = e[2] = 0.f;
#pragma unroll
  for (int q = 0; q < kSHC / 4; ++q) {
    const float4 v = row[q];
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * q + i;             // coefficient j / 3, channel j % 3
      e[j % 3] += basis[j / 3] * w[i];
    }
  }
}

// Per-point quantities shared by every sample.
struct Point {
  float nx, ny, nz;                 // normal as given (transport)
  float m_v, M_v;                   // length of the view direction
  float vx, vy, vz;                 // unit view direction
  float vlx, vly, vlz;              // its rounding error (see ggx)
  float nsx, nsy, nsz;              // unit normal flipped towards v
  float r, alpha, alpha2, k;
  float NoV, nom1;
  bool nov_pass;                    // NoV >= 1e-6 in float64: d NoV passes
};

__device__ __forceinline__ Point load_point(const float* __restrict__ nrm,
                                            const float* __restrict__ vdir,
                                            const float* __restrict__ rough,
                                            int p) {
  Point q;
  q.nx = nrm[3 * p]; q.ny = nrm[3 * p + 1]; q.nz = nrm[3 * p + 2];
  const float vdx = vdir[3 * p], vdy = vdir[3 * p + 1], vdz = vdir[3 * p + 2];
  q.m_v = sqrtf(vdx * vdx + vdy * vdy + vdz * vdz);
  q.M_v = fmaxf(q.m_v, 1e-12f);
  q.vx = vdx / q.M_v; q.vy = vdy / q.M_v; q.vz = vdz / q.M_v;
  const double M_vd = fmax(sqrt(static_cast<double>(vdx) * vdx
                                + static_cast<double>(vdy) * vdy
                                + static_cast<double>(vdz) * vdz), 1e-12);
  const double Vx = vdx / M_vd, Vy = vdy / M_vd, Vz = vdz / M_vd;
  q.vlx = static_cast<float>(Vx - q.vx);
  q.vly = static_cast<float>(Vy - q.vy);
  q.vlz = static_cast<float>(Vz - q.vz);
  const float M_n = fmaxf(sqrtf(q.nx * q.nx + q.ny * q.ny + q.nz * q.nz), 1e-12f);
  const float nhx = q.nx / M_n, nhy = q.ny / M_n, nhz = q.nz / M_n;
  // sign(V.N) and NoV's clip decision from float64 (see the branch list):
  // V and N normalised in double, as the reference normalises them.
  const double M_nd = fmax(sqrt(static_cast<double>(q.nx) * q.nx
                                + static_cast<double>(q.ny) * q.ny
                                + static_cast<double>(q.nz) * q.nz), 1e-12);
  const double s = Vx * (q.nx / M_nd) + Vy * (q.ny / M_nd) + Vz * (q.nz / M_nd);
  const float sgn = s > 0.0 ? 1.f : (s < 0.0 ? -1.f : 0.f);
  q.nsx = nhx * sgn; q.nsy = nhy * sgn; q.nsz = nhz * sgn;
  q.nov_pass = sgn * s >= 1e-6;
  q.r = rough[p];
  q.alpha = q.r * q.r;
  q.alpha2 = q.alpha * q.alpha;
  q.k = (q.alpha + 2.f * q.r + 1.f) / 8.f;
  q.NoV = clip(q.nsx * q.vx + q.nsy * q.vy + q.nsz * q.vz, 1e-6f, 1.f);
  q.nom1 = q.NoV * (1.f - q.k) + q.k;
  return q;
}

// One sample's GGX chain (_chain), with what the backward reads.
struct Ggx {
  float hx, hy, hz, m_h, rM_h;       // unit half vector, |h0|, 1 / max(|h0|, eps)
  float NoH_raw, VoH_raw, NoL, NoH, VoH;
  float cx, cy, cz;                  // ns x h, zero below the NoH clip
  float e2, frac0, u, nom0, nom2, q, r_nom, f_s;
};

__device__ __forceinline__ Ggx ggx(const Point& pt, float dx, float dy,
                                   float dz) {
  Ggx s;
  // h0 = (d + V) / 2 with V to twice float32's precision. Where d is near
  // -V, d + V cancels: float32's rounding of V would be all of h0's error,
  // eps / |h0| of it, and the gradients scale as 1 / |h0|. d + vx is exact
  // there (Sterbenz), so adding the rounding error keeps h0 to a few eps.
  const float h0x = ((dx + pt.vx) + pt.vlx) * 0.5f;
  const float h0y = ((dy + pt.vy) + pt.vly) * 0.5f;
  const float h0z = ((dz + pt.vz) + pt.vlz) * 0.5f;
  s.m_h = sqrtf(h0x * h0x + h0y * h0y + h0z * h0z);
  s.rM_h = 1.f / fmaxf(s.m_h, 1e-12f);
  s.hx = h0x * s.rM_h; s.hy = h0y * s.rM_h; s.hz = h0z * s.rM_h;
  const float NoL_raw = pt.nsx * dx + pt.nsy * dy + pt.nsz * dz;
  s.NoH_raw = pt.nsx * s.hx + pt.nsy * s.hy + pt.nsz * s.hz;
  s.VoH_raw = pt.vx * s.hx + pt.vy * s.hy + pt.vz * s.hz;
  s.NoL = clip(NoL_raw, 1e-6f, 1.f);
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
  s.r_nom = 1.f / clip(s.q, 1e-6f, k4Pi);
  s.f_s = s.u * s.r_nom;
  return s;
}

// max(e_c, 0) decides the SH gradient's branch: 1, 1/2 at 0, else 0. The
// float32 basis is within ~10 eps of the exact one per entry, and the sum
// of 16 products adds ~18 eps sum_k |shs_kc|: below kSignTol sum_k |shs_kc|
// float32's e_c can have the other sign than the float64 reference's.
constexpr float kSignTol = 1e-5f;

__device__ __forceinline__ float relu_branch(float e) {
  return e > 0.f ? 1.f : (e == 0.f ? 0.5f : 0.f);
}

// e_c in float64 from the float32 direction and SH row.
__device__ __forceinline__ double light64(float x, float y, float z,
                                          const float* shs_row, int c) {
  double basis[kSH];
  sh_basis<double>(x, y, z, basis);
  double e = 0.0;
  for (int k = 0; k < kSH; ++k) e += basis[k] * shs_row[3 * k + c];
  return e;
}

// The bands about 1e-6 inside which float32 can decide q's and VoH's lower
// clips otherwise than float64 (derived in the branch list): |q - 1e-6|
// within kQBand of 1e-6, |VoH - 1e-6| within kVoHBand.
constexpr float kQBand = 5e-4f;
constexpr float kVoHBand = 2e-6f;

struct Clips {
  bool q, voh;                      // the gradient passes q's, VoH's clip
};

// Double-double: the unevaluated sum hi + lo of two doubles, ~106 bits.
struct DD {
  double hi, lo;
};

__device__ __forceinline__ DD two_sum(double a, double b) {   // exact
  const double s = a + b, bb = s - a;
  return {s, (a - (s - bb)) + (b - bb)};
}

__device__ __forceinline__ DD dd_add(DD a, DD b) {
  DD s = two_sum(a.hi, b.hi);
  const DD t = two_sum(a.lo, b.lo);
  s = two_sum(s.hi, s.lo + t.hi);
  return two_sum(s.hi, s.lo + t.lo);
}

// a . b of float32 vectors: each product is exact in double, the sum is
// within 2^-106 of the exact one.
__device__ __forceinline__ DD dot3_dd(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  const DD s = two_sum(static_cast<double>(a0) * b0,
                       static_cast<double>(a1) * b1);
  const DD t = two_sum(s.hi, static_cast<double>(a2) * b2);
  return two_sum(t.hi, t.lo + s.lo);
}

__device__ __forceinline__ DD dd_sqrt(DD a) {
  const double r = sqrt(a.hi);
  const double e = fma(-r, r, a.hi) + a.lo;    // a - r^2, r^2 exact by fma
  return two_sum(r, e / (2.0 * r));
}

// VoH >= 1e-6 for the float32 view direction V and sample d. VoH =
// V.(d + V) / |d + V| with V and d normalised is (V.d + |V|) / ||V| d + V|
// with V as it is, so the decision is the sign of V.d + |V| - 1e-6
// ||V| d + V|. V.d + |V| cancels to ~3e-10 |V| where VoH reaches 1e-6, and
// is taken in double-double (error ~1e-32 |V|); ||V| d + V| is ~3e-4 |V|
// there and its double's relative error ~1e-12, so the right side is within
// ~1e-22 |V|, ~1e-12 of 1e-6 in VoH: the decision is the exact one on the
// inputs wherever VoH lies farther from 1e-6 than that (the k4-branches
// phase forces it to 1e-8 of 1e-6). ops/shading_cuda.py::voh_passes_dd
// repeats it.
__device__ __forceinline__ bool voh_passes(const float* __restrict__ vdir,
                                           int p, float dx, float dy,
                                           float dz) {
  const float v0 = vdir[3 * p], v1 = vdir[3 * p + 1], v2 = vdir[3 * p + 2];
  const DD m = dd_sqrt(dot3_dd(v0, v1, v2, v0, v1, v2));          // |V|
  const DD a = dd_add(dot3_dd(v0, v1, v2, dx, dy, dz), m);
  const double wx = fma(m.hi, static_cast<double>(dx),
                        static_cast<double>(v0));
  const double wy = fma(m.hi, static_cast<double>(dy),
                        static_cast<double>(v1));
  const double wz = fma(m.hi, static_cast<double>(dz),
                        static_cast<double>(v2));
  const DD diff = dd_add(a, {-1e-6 * sqrt(wx * wx + wy * wy + wz * wz), 0.0});
  return diff.hi > 0.0 || (diff.hi == 0.0 && diff.lo >= 0.0);
}

// q's lower-clip decision of one sample in float64, from the float32 inputs
// in the plain version's form (ops/shading.py::ggx_terms): V, N and h
// normalised in double, nom0 = NoH^2 (alpha^2 - 1) + 1; VoH's from
// voh_passes.
__device__ __forceinline__ Clips clips64(const float* __restrict__ nrm,
                                      const float* __restrict__ vdir,
                                      float r, int p, float dx, float dy,
                                      float dz) {
  const double v0 = vdir[3 * p], v1 = vdir[3 * p + 1], v2 = vdir[3 * p + 2];
  const double n0 = nrm[3 * p], n1 = nrm[3 * p + 1], n2 = nrm[3 * p + 2];
  const double mv = fmax(sqrt(v0 * v0 + v1 * v1 + v2 * v2), 1e-12);
  const double mn = fmax(sqrt(n0 * n0 + n1 * n1 + n2 * n2), 1e-12);
  const double vx = v0 / mv, vy = v1 / mv, vz = v2 / mv;
  double nx = n0 / mn, ny = n1 / mn, nz = n2 / mn;
  const double s = vx * nx + vy * ny + vz * nz;
  const double sgn = s > 0.0 ? 1.0 : (s < 0.0 ? -1.0 : 0.0);
  nx *= sgn; ny *= sgn; nz *= sgn;
  double hx = (dx + vx) / 2.0, hy = (dy + vy) / 2.0, hz = (dz + vz) / 2.0;
  const double mh = fmax(sqrt(hx * hx + hy * hy + hz * hz), 1e-12);
  hx /= mh; hy /= mh; hz /= mh;
  const double NoV = fmin(fmax(nx * vx + ny * vy + nz * vz, 1e-6), 1.0);
  const double NoH = fmin(fmax(nx * hx + ny * hy + nz * hz, 1e-6), 1.0);
  const double NoL = fmin(fmax(nx * dx + ny * dy + nz * dz, 1e-6), 1.0);
  const double rd = r, alpha = rd * rd, alpha2 = alpha * alpha;
  const double k = (alpha + 2.0 * rd + 1.0) / 8.0;
  const double nom0 = NoH * NoH * (alpha2 - 1.0) + 1.0;
  const double pi4 = 4.0 * 3.14159265358979323846;
  const double q = pi4 * nom0 * nom0 * (NoV * (1.0 - k) + k)
                   * (NoL * (1.0 - k) + k);
  return {q >= 1e-6 && q <= pi4, voh_passes(vdir, p, dx, dy, dz)};
}

// One sample's local light e_c (before the clip) and transport factor
// an = area max(n . d, 0).
__device__ __forceinline__ void light_terms(const Point& pt, float dx,
                                            float dy, float dz, float area,
                                            const float* shs_row, float* e,
                                            float& an) {
  float basis[kSH];
  sh_basis<float>(dx, dy, dz, basis);
  sh_light(basis, shs_row, e);
  an = area * fmaxf(pt.nx * dx + pt.ny * dy + pt.nz * dz, 0.f);
}

// Slots of the backward's per-lane sums: the 48 SH gradients first, so the
// group's reduce-scatter leaves lane g < 3 with SH gradients [16 g, 16 g + 16)
// and lane 3 with the rest.
constexpr int kDif = kSHC;          // 3: sum of trans_c
constexpr int kGAlpha2 = kDif + 3;  // d alpha2
constexpr int kGNom1 = kGAlpha2 + 1;
constexpr int kGK2 = kGNom1 + 1;    // d k through nom2
constexpr int kGV = kGK2 + 1;       // 3: d v-hat through VoH and h
constexpr int kSums = 64;           // 57 used

// Whether float32 could decide q's or VoH's lower clip otherwise than
// float64: the operand lies within its band about 1e-6.
__device__ __forceinline__ bool in_band(const Ggx& s) {
  return fabsf(s.q - 1e-6f) <= kQBand * 1e-6f
         || fabsf(s.VoH_raw - 1e-6f) <= kVoHBand;
}

// VoH's gradient through the Fresnel term, for gu = d f_s / q.
__device__ __forceinline__ float voh_grad(const Point& pt, const Ggx& s,
                                          float gu) {
  return gu * pt.alpha2 * (1.f - kFresnel) * kLn2 * s.e2
         * (-2.f * 5.55473f * s.VoH - 6.98316f);
}

// The part of one sample's GGX backward that q's and VoH's clips mask: for
// the denominator's gradient gq and VoH's gVoH (each 0 where its clip
// masks it), adds into the point's sums g[0, 6) (slots kGAlpha2 to kGV + 2:
// d alpha2, d nom1, d k through nom2, d v-hat). Linear in gq and gVoH, so
// the fix-up kernel corrects a decision by the difference.
__device__ __forceinline__ void ggx_bwd(const Point& pt, const Ggx& s,
                                        float gq, float gVoH, float* g) {
  const float gnom0 = gq * k4Pi * 2.f * s.nom0 * pt.nom1 * s.nom2;
  g[kGNom1 - kGAlpha2] += gq * k4Pi * s.nom0 * s.nom0 * s.nom2;
  const float gnom2 = gq * k4Pi * s.nom0 * s.nom0 * pt.nom1;
  g[0] += gnom0 * s.NoH * s.NoH;
  // NoH, VoH and NoV are dot products of unit vectors: they pass 1 only by
  // rounding, so only the lower clip masks their gradients.
  const float gNoH = s.NoH_raw >= 1e-6f
      ? gnom0 * 2.f * s.NoH * (pt.alpha2 - 1.f) : 0.f;
  g[kGK2 - kGAlpha2] += gnom2 * (1.f - s.NoL);
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
  g[kGV - kGAlpha2] += gVoH * s.hx + 0.5f * ghx * s.rM_h;
  g[kGV + 1 - kGAlpha2] += gVoH * s.hy + 0.5f * ghy * s.rM_h;
  g[kGV + 2 - kGAlpha2] += gVoH * s.hz + 0.5f * ghz * s.rM_h;
}

// A point's d roughness and d view direction from its GGX sums g[0, 6) (as
// ggx_bwd adds them); linear in them.
__device__ __forceinline__ void point_grads(const Point& pt, const float* g,
                                            float& drough, float* dvdir) {
  const float gnom1 = g[kGNom1 - kGAlpha2];
  const float gk = gnom1 * (1.f - pt.NoV) + g[kGK2 - kGAlpha2];
  const float gvhx = g[kGV - kGAlpha2], gvhy = g[kGV + 1 - kGAlpha2],
              gvhz = g[kGV + 2 - kGAlpha2];
  const float gNoV = pt.nov_pass ? gnom1 * (1.f - pt.k) : 0.f;
  const float galpha = g[0] * 2.f * pt.alpha + gk * (1.f / 8.f);
  drough = galpha * 2.f * pt.r + gk * 0.25f;
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
  dvdir[0] = dvx / pt.M_v;
  dvdir[1] = dvy / pt.M_v;
  dvdir[2] = dvz / pt.M_v;
}

__global__ void __launch_bounds__(kThreads, 5)
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
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x, lane = tid & 31;
  const int pt = tid / kGroup, g = tid % kGroup;
  const int p0 = blockIdx.x * kPoints;
  const int n_pts = min(kPoints, P - p0);
  const int p = p0 + pt;
  const bool active = pt < n_pts;
  const Source src{dirs, vis, area, gl, S};
  const int n_chunks = (S + kChunk - 1) / kChunk;

  stage_shs(sm.shs, shs + static_cast<size_t>(p0) * kSHC, n_pts, tid);
  for (int ch = 0; ch < kStages - 1; ++ch)
    stage_ahead(sm, src, p0, n_pts, ch, tid);
  Point ptc;
  if (active) ptc = load_point(nrm, vdir, rough, p);
  const float* shs_row = sm.shs + pt * kRowSH;

  // {dif_0, spec_0, dif_1, spec_1, dif_2, spec_2, -, -}: after the group's
  // reduce-scatter lane c holds channel c's pair.
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kChunk, n = min(kChunk, S - c0);
    stage_ahead(sm, src, p0, n_pts, ch + kStages - 1, tid);
    r3dg::cp_async_wait<kStages - 1>();   // this thread's chunk ch has landed
    __syncthreads();
    if (active) {
      const Rows rows = point_rows(sm.stage[ch % kStages], src, p, pt, c0);
      for (int j = g; j < n; j += kGroup) {
        const float dx = rows.dirs[3 * j], dy = rows.dirs[3 * j + 1],
                    dz = rows.dirs[3 * j + 2];
        const float v = rows.vis[j];
        const Ggx s = ggx(ptc, dx, dy, dz);
        float e[3], an;
        light_terms(ptc, dx, dy, dz, rows.area[j], shs_row, e, an);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float trans = (fmaxf(e[c], 0.f) + rows.light[3 * j + c] * v) * an;
          acc[2 * c] += trans;
          acc[2 * c + 1] += s.f_s * trans;
        }
      }
    }
    __syncthreads();            // the next stage overwrites this buffer
  }
  r3dg::scatter_step<4, 2>(acc, lane);
  r3dg::scatter_step<2, 1>(acc, lane);
  if (active && g < 3) {
    const float d = acc[0] / S, sp = acc[1] / S;
    dif[3 * p + g] = d;
    spec[3 * p + g] = sp;
    pbr[3 * p + g] = bc[3 * p + g] / kPi * d + sp;
  }
}

__global__ void __launch_bounds__(kThreads, 4)
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
                 float* __restrict__ dgl,          // [P, S, 3]
                 int* __restrict__ unsure_list) {  // [1 + P]: count, points
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x, lane = tid & 31;
  const int pt = tid / kGroup, g = tid % kGroup;
  const int p0 = blockIdx.x * kPoints;
  const int n_pts = min(kPoints, P - p0);
  const int p = p0 + pt;
  const bool active = pt < n_pts;
  const Source src{dirs, vis, area, gl, S};
  const int n_chunks = (S + kChunk - 1) / kChunk;

  stage_shs(sm.shs, shs + static_cast<size_t>(p0) * kSHC, n_pts, tid);
  for (int ch = 0; ch < kStages - 1; ++ch)
    stage_ahead(sm, src, p0, n_pts, ch, tid);
  Point ptc;
  float gD[3], gS[3];           // d trans_c, d (f_s trans_c), over S
  if (active) {
    ptc = load_point(nrm, vdir, rough, p);
    const float inv_s = 1.f / S;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float gpc = gpbr[3 * p + c];
      gD[c] = (gdif[3 * p + c] + gpc * bc[3 * p + c] / kPi) * inv_s;
      gS[c] = (gspec[3 * p + c] + gpc) * inv_s;
    }
  }
  float* shs_row = sm.shs + pt * kRowSH;   // [48] SH, [48, 51) sign_tol
  int unsure = 0;               // a sample for shade_bwd_fix_kernel

  float acc[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kChunk, n = min(kChunk, S - c0);
    Stage& st = sm.stage[ch % kStages];
    stage_ahead(sm, src, p0, n_pts, ch + kStages - 1, tid);
    r3dg::cp_async_wait<kStages - 1>();   // this thread's chunk ch has landed
    __syncthreads();
    if (ch == 0) {              // the SH rows landed with chunk 0
      if (active && g < 3) {    // sign_tol_g = kSignTol sum_k |shs_kg|
        float t = 0.f;
        for (int k = 0; k < kSH; ++k) t += fabsf(shs_row[3 * k + g]);
        shs_row[kSHC + g] = kSignTol * t;
      }
      __syncthreads();
    }
    if (active) {
      const Rows rows = point_rows(st, src, p, pt, c0);
      for (int j = g; j < n; j += kGroup) {
        const float dx = rows.dirs[3 * j], dy = rows.dirs[3 * j + 1],
                    dz = rows.dirs[3 * j + 2];
        const float v = rows.vis[j];
        float e[3], an;
        light_terms(ptc, dx, dy, dz, rows.area[j], shs_row, e, an);
        const Ggx s = ggx(ptc, dx, dy, dz);
        float gf = 0.f, ge[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float trans = (fmaxf(e[c], 0.f) + rows.light[3 * j + c] * v) * an;
          acc[kDif + c] += trans;
          const float gtrans = gD[c] + gS[c] * s.f_s;
          gf += gS[c] * trans;
          const float glight = gtrans * an;
          rows.light[3 * j + c] = glight * v;      // dgl, over the light read
          // max(e, 0) passes half the gradient at e == 0, as jnp.maximum and
          // torch.maximum do: the local-light SH start at zero in stage 2
          // (and all-zero SH give sign_tol 0: e is 0 in every precision).
          ge[c] = relu_branch(e[c]) * glight;
          unsure |= fabsf(e[c]) < shs_row[kSHC + c];
        }

        // GGX backward. A sample whose q or VoH lies in its band about 1e-6
        // puts its point on the list: shade_bwd_fix_kernel takes those
        // clips' decisions from float64.
        unsure |= in_band(s);
        const float gu = gf * s.r_nom;
        acc[kGAlpha2] += gu * s.frac0;
        ggx_bwd(ptc, s, inside(s.q, 1e-6f, k4Pi) ? -gf * s.f_s * s.r_nom : 0.f,
                s.VoH_raw >= 1e-6f ? voh_grad(ptc, s, gu) : 0.f,
                &acc[kGAlpha2]);

        // SH gradients, from the basis evaluated again
        float basis[kSH];
        sh_basis<float>(dx, dy, dz, basis);
#pragma unroll
        for (int k = 0; k < kSH; ++k) {
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[3 * k + c] += basis[k] * ge[c];
        }
      }
    }
    __syncthreads();            // this chunk's dgl is in shared memory
    for (int r = tid / 32; r < n_pts; r += kThreads / 32) {   // a warp a row
      const size_t at = 3 * (static_cast<size_t>(p0 + r) * S + c0);
      const float* row = st.light + r * kRow3 + phase(gl + at);
      for (int i = lane; i < 3 * n; i += 32) dgl[at + i] = row[i];
    }
    __syncthreads();            // the next stage overwrites this buffer
  }

  // The points with an unsure sample on any lane of their group go on a
  // list; shade_bwd_fix_kernel takes those samples' branches from float64.
  unsure |= __shfl_xor_sync(r3dg::kFullMask, unsure, 1);
  unsure |= __shfl_xor_sync(r3dg::kFullMask, unsure, 2);
  if (active && g == 0 && unsure)
    unsure_list[1 + atomicAdd(unsure_list, 1)] = p;

  r3dg::scatter_step<kSums / 2, 2>(acc, lane);
  r3dg::scatter_step<kSums / 4, 1>(acc, lane);
  if (!active) return;
  if (g < 3) {                  // SH gradients [16 g, 16 g + 16)
    float* out = dshs + static_cast<size_t>(p) * kSHC + 16 * g;
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = acc[i];
    return;
  }
  // lane 3: acc[i] is the group's sum of slot kDif + i
  float dr, dv[3];
  point_grads(ptc, &acc[kGAlpha2 - kDif], dr, dv);
  drough[p] = dr;
  dvdir[3 * p] = dv[0];
  dvdir[3 * p + 1] = dv[1];
  dvdir[3 * p + 2] = dv[2];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    dbc[3 * p + c] = gpbr[3 * p + c] * (acc[c] / S) / kPi;
}

// The points on K4-bwd's unsure list, a warp a point (kFixWarps warps take
// the list in turn), lane l taking samples l, l + 32, ..., each found as
// shade_bwd_kernel finds it, in the same order:
//   * a sample whose |e_c| is below sign_tol_c takes max(e, 0)'s branch
//     from e in float64, and where that branch differs from float32's,
//     dshs moves by the difference times the sample's light gradient;
//   * a sample whose q or VoH lies in its band (in_band) takes both clips'
//     decisions from float64 (clips64), and where one differs from
//     float32's, the GGX sums move by ggx_bwd of the difference, and
//     d roughness and d view direction by point_grads of that.
// Each correction is summed over the warp in a fixed order and added by
// lane 0. The list's order does not matter: each point is one warp's.
constexpr int kFixWarps = 512;

// One point of shade_bwd_fix_kernel, on one warp.
__device__ __forceinline__ void fix_point(
    const float* __restrict__ dirs, const float* __restrict__ vis,
    const float* __restrict__ area, const float* __restrict__ gl,
    const float* __restrict__ bc, const float* __restrict__ rough,
    const float* __restrict__ nrm, const float* __restrict__ vdir,
    const float* __restrict__ shs, const float* __restrict__ gpbr,
    const float* __restrict__ gdif, const float* __restrict__ gspec, int p,
    int S, int lane, float* __restrict__ drough, float* __restrict__ dvdir,
    float* __restrict__ dshs) {
  const float* row = shs + static_cast<size_t>(p) * kSHC;
  float tol[3] = {0.f, 0.f, 0.f};
  for (int k = 0; k < kSH; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) tol[c] += fabsf(row[3 * k + c]);
  }
  const Point ptc = load_point(nrm, vdir, rough, p);
  float gD[3], gS[3];
  const float inv_s = 1.f / S;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    tol[c] *= kSignTol;
    const float gpc = gpbr[3 * p + c];
    gD[c] = (gdif[3 * p + c] + gpc * bc[3 * p + c] / kPi) * inv_s;
    gS[c] = (gspec[3 * p + c] + gpc) * inv_s;
  }
  float fix_sum[kSHC], clip_sum[6];
#pragma unroll
  for (int i = 0; i < kSHC; ++i) fix_sum[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) clip_sum[i] = 0.f;
  bool moved_any = false, clipped_any = false;
  for (int j = lane; j < S; j += 32) {
    const size_t at = static_cast<size_t>(p) * S + j;
    const float dx = dirs[3 * at], dy = dirs[3 * at + 1], dz = dirs[3 * at + 2];
    float basis[kSH], e[3] = {0.f, 0.f, 0.f};
    sh_basis<float>(dx, dy, dz, basis);
#pragma unroll
    for (int i = 0; i < kSHC; ++i) e[i % 3] += basis[i / 3] * row[i];
    float fix[3];
    bool moved = false;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      fix[c] = 0.f;
      if (fabsf(e[c]) < tol[c]) {
        const double e64 = light64(dx, dy, dz, row, c);
        fix[c] = (e64 > 0.0 ? 1.f : (e64 == 0.0 ? 0.5f : 0.f))
                 - relu_branch(e[c]);
        moved |= fix[c] != 0.f;
      }
    }
    const Ggx s = ggx(ptc, dx, dy, dz);
    float fq = 0.f, fv = 0.f;   // float64's decision minus float32's
    if (in_band(s)) {
      const Clips c64 = clips64(nrm, vdir, ptc.r, p, dx, dy, dz);
      fq = static_cast<float>(c64.q)
           - static_cast<float>(inside(s.q, 1e-6f, k4Pi));
      fv = static_cast<float>(c64.voh)
           - static_cast<float>(s.VoH_raw >= 1e-6f);
    }
    const bool clipped = fq != 0.f || fv != 0.f;
    if (!moved && !clipped) continue;
    const float an = area[at] * fmaxf(ptc.nx * dx + ptc.ny * dy + ptc.nz * dz, 0.f);
    if (moved) {
      moved_any = true;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float gfix = fix[c] * (gD[c] + gS[c] * s.f_s) * an;
#pragma unroll
        for (int k = 0; k < kSH; ++k) fix_sum[3 * k + c] += basis[k] * gfix;
      }
    }
    if (clipped) {              // gf as shade_bwd_kernel sums it
      clipped_any = true;
      float gf = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        gf += gS[c] * ((fmaxf(e[c], 0.f) + gl[3 * at + c] * vis[at]) * an);
      ggx_bwd(ptc, s, fq * (-gf * s.f_s * s.r_nom),
              fv * voh_grad(ptc, s, gf * s.r_nom), clip_sum);
    }
  }
  if (__any_sync(r3dg::kFullMask, moved_any)) {
#pragma unroll
    for (int i = 0; i < kSHC; ++i) {
#pragma unroll
      for (int off = 16; off >= 1; off /= 2)
        fix_sum[i] += __shfl_xor_sync(r3dg::kFullMask, fix_sum[i], off);
    }
    if (lane == 0) {
      float* out = dshs + static_cast<size_t>(p) * kSHC;
#pragma unroll
      for (int i = 0; i < kSHC; ++i) out[i] += fix_sum[i];
    }
  }
  if (__any_sync(r3dg::kFullMask, clipped_any)) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int off = 16; off >= 1; off /= 2)
        clip_sum[i] += __shfl_xor_sync(r3dg::kFullMask, clip_sum[i], off);
    }
    if (lane == 0) {
      float dr, dv[3];
      point_grads(ptc, clip_sum, dr, dv);
      drough[p] += dr;
#pragma unroll
      for (int i = 0; i < 3; ++i) dvdir[3 * p + i] += dv[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
shade_bwd_fix_kernel(const float* __restrict__ dirs,
                     const float* __restrict__ vis,
                     const float* __restrict__ area,
                     const float* __restrict__ gl,
                     const float* __restrict__ bc,
                     const float* __restrict__ rough,
                     const float* __restrict__ nrm,
                     const float* __restrict__ vdir,
                     const float* __restrict__ shs,
                     const float* __restrict__ gpbr,
                     const float* __restrict__ gdif,
                     const float* __restrict__ gspec,
                     const int* __restrict__ unsure_list, int S,
                     float* __restrict__ drough, float* __restrict__ dvdir,
                     float* __restrict__ dshs) {
  const int lane = threadIdx.x & 31;
  const int n = unsure_list[0];
  for (int w = blockIdx.x * (kThreads / 32) + threadIdx.x / 32; w < n;
       w += kFixWarps) {
    fix_point(dirs, vis, area, gl, bc, rough, nrm, vdir, shs, gpbr, gdif,
              gspec, unsure_list[1 + w], S, lane, drough, dvdir, dshs);
  }
}

}  // namespace

extern "C" int r3dg_shade_fwd(const void* dirs, const void* vis,
                              const void* area, const void* gl, const void* bc,
                              const void* rough, const void* nrm,
                              const void* vdir, const void* shs, int P, int S,
                              void* pbr, void* dif, void* spec, void* stream) {
  if (P <= 0) return 0;
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (P + kPoints - 1) / kPoints;
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
                              void* unsure, void* stream) {
  if (P <= 0) return 0;
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (P + kPoints - 1) / kPoints;
  cudaError_t err = cudaMemsetAsync(unsure, 0, sizeof(int),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  shade_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(vis),
      static_cast<const float*>(area), static_cast<const float*>(gl),
      static_cast<const float*>(bc), static_cast<const float*>(rough),
      static_cast<const float*>(nrm), static_cast<const float*>(vdir),
      static_cast<const float*>(shs), static_cast<const float*>(gpbr),
      static_cast<const float*>(gdif), static_cast<const float*>(gspec), P, S,
      static_cast<float*>(dbc), static_cast<float*>(drough),
      static_cast<float*>(dvdir), static_cast<float*>(dshs),
      static_cast<float*>(dgl), static_cast<int*>(unsure));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  shade_bwd_fix_kernel<<<kFixWarps / (kThreads / 32), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(vis),
      static_cast<const float*>(area), static_cast<const float*>(gl),
      static_cast<const float*>(bc), static_cast<const float*>(rough),
      static_cast<const float*>(nrm), static_cast<const float*>(vdir),
      static_cast<const float*>(shs), static_cast<const float*>(gpbr),
      static_cast<const float*>(gdif), static_cast<const float*>(gspec),
      static_cast<const int*>(unsure), S, static_cast<float*>(drough),
      static_cast<float*>(dvdir), static_cast<float*>(dshs));
  return static_cast<int>(cudaGetLastError());
}

"""Kernel K4: the fused stage-2 train shading on the card.

Port of relightable3dgaussian_tpu/ops/shading_pallas.py. K4's forward and
backward (`csrc/shading.cu`) replace the TPU kernels `_fwd_kernel` and
`_bwd_kernel`.

`rendering_equation_train` takes `ops/shading.py::rendering_equation`'s
inputs with the env query already applied (`global_light` [P, S, 3]) and
returns (pbr, diffuse_light, specular), each [P, 3]:
  * CPU tensors → `rendering_equation_train_reference`, the plain version,
    differentiated by autograd;
  * CUDA tensors → `ShadeFunction`, whose forward is K4-fwd and whose
    backward is K4-bwd, or an exception. Nothing falls back.
As in the train step, normals, visibility, directions and areas are
constants: K4 gives them no gradient. The tracer's counter `k4.launches`
counts K4-fwd's launches and `k4.bwd_launches` K4-bwd's (a call of
`shade_bwd`: the backward kernel and its fix-up, which takes a listed
point's unsure branches from float64, one launch each).
"""
from __future__ import annotations

import math

import torch

from . import _build
from .shading import ggx_terms, rendering_equation

KERNEL = "shading"
N_SH = 16          # csrc/shading.cu kSH: degree-3 local-light SH
POINTS_PER_BLOCK = 32   # csrc/shading.cu kPoints: a block's run of points
FLOAT32_CLIP = float(torch.tensor(1e-6, dtype=torch.float32))    # 1e-6f
FLOAT32_TINY = float(torch.tensor(1e-12, dtype=torch.float32))   # 1e-12f
K4_PI4 = 4 * float(torch.tensor(math.pi, dtype=torch.float32))   # k4Pi
# csrc/shading.cu kQBand, kVoHBand: where K4's float32 q lies within
# Q_BAND of 1e-6 (relative), or its VoH within VOH_BAND, K4's fix-up takes
# q's decision from float64 and VoH's past it (k4_clip_passes)
Q_BAND, VOH_BAND = 5e-4, float(torch.tensor(2e-6, dtype=torch.float32))
_K4_FWD = _build.Entry(KERNEL, "r3dg_shade_fwd", "ppppppppp ii ppp", "K4-fwd",
                       ("k4.launches",))
_K4_BWD = _build.Entry(KERNEL, "r3dg_shade_bwd", "pppppppppppp ii pppppp",
                       "K4-bwd", ("k4.bwd_launches",))


def rendering_equation_train_reference(base_color, roughness, normals,
                                       viewdirs, incidents_shs, global_light,
                                       visibility, incident_dirs,
                                       incident_areas, voh_pass=None):
    """The plain version: `rendering_equation` with a precomputed light
    (`voh_pass`: ops/shading.py::ggx_terms')."""
    pbr, ex = rendering_equation(base_color, roughness, normals, viewdirs,
                                 incidents_shs, lambda d: global_light,
                                 visibility, incident_dirs, incident_areas,
                                 voh_pass=voh_pass)
    return pbr, ex["diffuse_light"], ex["specular"]


def rendering_equation_train(base_color, roughness, normals, viewdirs,
                             incidents_shs, global_light, visibility,
                             incident_dirs, incident_areas):
    """The train-step shading: the plain version on CPU tensors, K4 on CUDA
    tensors. Returns (pbr, diffuse_light, specular), each [P, 3]."""
    args = (base_color, roughness, normals, viewdirs, incidents_shs,
            global_light, visibility, incident_dirs, incident_areas)
    devices = {a.device.type for a in args}
    if devices == {"cpu"}:
        return rendering_equation_train_reference(*args)
    if devices != {"cuda"}:
        raise ValueError(f"rendering_equation_train: inputs on "
                         f"{sorted(devices)}; expected all on CPU or all on CUDA")
    return ShadeFunction.apply(*args)


class ShadeFunction(torch.autograd.Function):
    """(base_color, roughness, viewdirs, incidents_shs, global_light) →
    (pbr, diffuse_light, specular) by K4-fwd; the backward is K4-bwd."""

    @staticmethod
    def forward(ctx, base_color, roughness, normals, viewdirs, incidents_shs,
                global_light, visibility, incident_dirs, incident_areas):
        inputs = kernel_inputs(base_color, roughness, normals, viewdirs,
                                incidents_shs, global_light, visibility,
                                incident_dirs, incident_areas)
        ctx.save_for_backward(*inputs)
        ctx.shs_shape = incidents_shs.shape
        return shade_fwd(*inputs)

    @staticmethod
    def backward(ctx, g_pbr, g_dif, g_spec):
        grads = shade_bwd(*ctx.saved_tensors, g_pbr.contiguous(),
                          g_dif.contiguous(), g_spec.contiguous())
        dbc, drough, dvdir, dshs, dgl = grads
        d_incidents = dshs.view(-1, N_SH, 3)
        if ctx.shs_shape[1] > N_SH:          # K4 reads the first 16 only
            d_incidents = torch.cat((d_incidents, d_incidents.new_zeros(
                (ctx.shs_shape[0], ctx.shs_shape[1] - N_SH, 3))), 1)
        return (dbc, drough[:, None], None, dvdir, d_incidents, dgl, None,
                None, None)


def view_side(normals: torch.Tensor, viewdirs: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """sign(V·N) a point [P] as float32 alone rounds it, and K4's, which is
    the float64 reference's.

    K4 (csrc/shading.cu::load_point) normalises V and N in double from the
    float32 inputs and takes the sign of their dot in double, as the
    reference does; it turns N to the viewer by that sign and zeroes N only
    where it is 0. The first sign is K4's float32 chain's, for a report of
    the points float32 alone would turn the other way or zero: IEEE sqrt
    and division, the products summed with FMAs as nvcc contracts them,
    ((vx nx + vy ny) + vz nz) as fma(vz, nz, fma(vy, ny, vx·nx)). Each FMA
    is one float64 product and sum of float32 values rounded once to
    float32 here (a double rounding, which can differ from the FMA only at
    a tie)."""
    s = _dot32(_unit32(viewdirs), _unit32(normals))
    return torch.sign(s), _sign64(normals, viewdirs)


def _sign64(normals: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
    """sign(V·N) [P] with V and N normalised in float64, as the reference
    and K4 take it."""
    n64, v64 = normals.double(), viewdirs.double()
    exact = ((v64 / v64.norm(dim=-1, keepdim=True))
             * (n64 / n64.norm(dim=-1, keepdim=True))).sum(-1)
    return torch.sign(exact)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A float64 tensor rounded to float32, kept in float64."""
    return t.float().double()


def _dot32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """((a0 b0 + a1 b1) + a2 b2) as nvcc contracts it into two FMAs, each
    a float64 product and sum of float32 values rounded once to float32."""
    s = _f32(a[..., 0] * b[..., 0])
    s = _f32(a[..., 1] * b[..., 1] + s)
    return _f32(a[..., 2] * b[..., 2] + s)


def _unit32(a: torch.Tensor) -> torch.Tensor:
    """a / max(sqrtf(a.a), 1e-12f) in K4's float32 (load_point)."""
    a = a.double()
    m = torch.clamp(_f32(torch.sqrt(_dot32(a, a))), min=FLOAT32_TINY)
    return _f32(a / m[..., None])


def k4_branch_operands(normals: torch.Tensor, viewdirs: torch.Tensor,
                       roughness: torch.Tensor, incident_dirs: torch.Tensor
                       ) -> dict:
    """The operands of K4's clips as K4 rounds them in float32: NoV [P]
    and NoH, VoH and the GGX denominator q [P, S] (csrc/shading.cu::
    load_point and ::ggx, in their expression order, each FMA emulated as
    in `view_side`, N turned by K4's sign from float64), as float64
    tensors. Which of two products nvcc fuses in a difference (the cross
    product) is a guess, so the operands are an estimate within their
    float32 error. `k4_clip_passes` takes K4's decisions from them."""
    f32, dot = _f32, _dot32
    vd = viewdirs.double()
    v, nh = _unit32(vd), _unit32(normals)
    # V's rounding error, kept per point from float64 (load_point: vl)
    vl = f32(vd / torch.clamp(vd.norm(dim=-1, keepdim=True), min=1e-12) - v)
    ns = nh * _sign64(normals, viewdirs)[:, None]
    r = roughness.double().reshape(-1)
    alpha = f32(r * r)
    alpha2 = f32(alpha * alpha)
    k = f32(f32(f32(alpha + 2 * r) + 1) / 8)
    one_k = f32(1 - k)
    nov = dot(ns, v)
    nom1 = f32(torch.clamp(nov, FLOAT32_CLIP, 1.0) * one_k + k)

    d = incident_dirs.double()
    h0 = f32(f32(f32(d + v[:, None]) + vl[:, None]) * 0.5)
    m_h = torch.clamp(f32(torch.sqrt(dot(h0, h0))), min=FLOAT32_TINY)
    h = f32(h0 * f32(1 / m_h)[..., None])
    nsb, vb = ns[:, None].expand_as(d), v[:, None].expand_as(d)
    noh, voh, nol = dot(nsb, h), dot(vb, h), dot(nsb, d)
    NoH = torch.clamp(noh, FLOAT32_CLIP, 1.0)

    def cross(i, j):            # ns_i h_j - ns_j h_i: fma(ns_i, h_j, -ns_j h_i)
        return f32(nsb[..., i] * h[..., j] - f32(nsb[..., j] * h[..., i]))

    c = torch.stack([cross(1, 2), cross(2, 0), cross(0, 1)], -1)
    NoH2 = f32(NoH * NoH)
    sin2 = torch.where(noh >= FLOAT32_CLIP, dot(c, c), f32(1 - NoH2))
    nom0 = f32(NoH2 * alpha2[:, None] + sin2)
    nom2 = f32(torch.clamp(nol, FLOAT32_CLIP, 1.0) * one_k[:, None]
               + k[:, None])
    q = f32(f32(f32(f32(K4_PI4 * nom0) * nom0) * nom1[:, None]) * nom2)
    return {"NoV": nov, "NoH": noh, "VoH": voh, "q": q}


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """a + b as an exact sum of two doubles (hi, lo)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """a b as an exact sum of two doubles (Dekker's split: what the
    kernel's fma gives)."""
    def split(x):
        c = 134217729.0 * x
        hi = c - (c - x)
        return hi, x - hi
    p = a * b
    (ah, al), (bh, bl) = split(a), split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _dd_add(a, b):
    s = _two_sum(a[0], b[0])
    t = _two_sum(a[1], b[1])
    s = _two_sum(s[0], s[1] + t[0])
    return _two_sum(s[0], s[1] + t[1])


def _dot3_dd(a: torch.Tensor, b: torch.Tensor):
    """a . b of float32 values in double-double (products exact)."""
    s = _two_sum(a[..., 0] * b[..., 0], a[..., 1] * b[..., 1])
    t = _two_sum(s[0], a[..., 2] * b[..., 2])
    return _two_sum(t[0], t[1] + s[1])


def voh_passes_dd(viewdirs: torch.Tensor, incident_dirs: torch.Tensor
                  ) -> torch.Tensor:
    """VoH >= 1e-6 [P, S] as K4's fix-up decides it (csrc/shading.cu::
    voh_passes): the sign of V.d + |V| - 1e-6 ||V| d + V| for the float32
    view direction V [P, 3] and samples d [P, S, 3], the first two terms in
    double-double, in float64 tensors. The fma of |V| d + V is a two-sum
    here, within an ulp of the kernel's: ~1e-16 of a term that moves the
    decision by as much of VoH, where the forced inputs put VoH 1e-8 of
    itself from 1e-6 (csrc/shading.cu)."""
    v = viewdirs.double()[:, None].expand_as(incident_dirs)
    d = incident_dirs.double()
    n = _dot3_dd(v, v)
    r = torch.sqrt(n[0])
    p, pe = _two_prod(r, r)
    m = _two_sum(r, ((n[0] - p) - pe + n[1]) / (2.0 * r))           # |V|
    a = _dd_add(_dot3_dd(v, d), m)
    p, pe = _two_prod(m[0][..., None], d)
    s, t = _two_sum(p, v)
    w = s + (t + pe)
    b = -1e-6 * torch.sqrt((w * w).sum(-1))
    hi, lo = _dd_add(a, (b, torch.zeros_like(b)))
    return (hi > 0) | ((hi == 0) & (lo >= 0))


def k4_clip_passes(normals: torch.Tensor, viewdirs: torch.Tensor,
                   roughness: torch.Tensor, incident_dirs: torch.Tensor
                   ) -> dict:
    """K4's lower-clip decisions, True where the clip passes the gradient:
    NoV [P] and NoH, VoH and q [P, S] (q within [1e-6, 4 pi]), by K4's rule
    (csrc/shading.cu, branch list): NoV from float64; at a sample where
    K4's float32 q lies within Q_BAND of 1e-6 or its VoH within VOH_BAND
    of 1e-6 (`k4_branch_operands`), q from float64 and VoH past it
    (`voh_passes_dd`, the exact decision), from float32 elsewhere; NoH
    from float32. The float64 operands are the plain version's in float64
    (ops/shading.py::ggx_terms), whose form K4's fix-up kernel repeats in
    double. "double" [P, S] marks the samples whose q and VoH decisions K4
    takes to its fix-up."""
    P = normals.shape[0]
    ops = k4_branch_operands(normals, viewdirs, roughness, incident_dirs)
    ex = {k: v.reshape(P, -1) for k, v in ggx_terms(
        normals.double(), viewdirs.double(), incident_dirs.double(),
        roughness.double().reshape(P, 1)).items()}
    q, voh = ops["q"], ops["VoH"]
    q_band = float(torch.tensor(Q_BAND, dtype=torch.float32)
                   * torch.tensor(1e-6, dtype=torch.float32))  # kQBand * 1e-6f
    double = ((_f32(q - FLOAT32_CLIP).abs() <= q_band)
              | (_f32(voh - FLOAT32_CLIP).abs() <= VOH_BAND))
    q64 = (ex["q"] >= 1e-6) & (ex["q"] <= 4 * math.pi)
    return {"NoV": ex["NoV"][:, 0] >= 1e-6,
            "NoH": ops["NoH"] >= FLOAT32_CLIP,
            "VoH": torch.where(double, voh_passes_dd(viewdirs, incident_dirs),
                               voh >= FLOAT32_CLIP),
            "q": torch.where(double, q64,
                             (q >= FLOAT32_CLIP) & (q <= K4_PI4)),
            "double": double}


def kernel_inputs(base_color, roughness, normals, viewdirs, incidents_shs,
                   global_light, visibility, incident_dirs, incident_areas):
    """The kernel's layout: [P, S, 3] dirs and light, [P, S] visibility and
    area, [P] roughness, [P, 48] SH (the first 16 coefficients)."""
    P, S = visibility.shape[:2]
    if incidents_shs.shape[1] < N_SH:
        raise ValueError(f"K4 takes {N_SH} SH coefficients, got "
                         f"{incidents_shs.shape[1]}")
    f = lambda x: x.detach().float().contiguous()  # noqa: E731
    return (f(incident_dirs), f(visibility.reshape(P, S)),
            f(incident_areas.expand(P, S, 1).reshape(P, S)), f(global_light),
            f(base_color), f(roughness.reshape(P)), f(normals), f(viewdirs),
            f(incidents_shs[:, :N_SH].reshape(P, 3 * N_SH)))


def _expect(dirs, vis, area, gl, bc, rough, nrm, vdir, shs) -> dict:
    P, S = vis.shape
    return {"incident_dirs": (dirs, (P, S, 3)), "visibility": (vis, (P, S)),
            "incident_areas": (area, (P, S)), "global_light": (gl, (P, S, 3)),
            "base_color": (bc, (P, 3)), "roughness": (rough, (P,)),
            "normals": (nrm, (P, 3)), "viewdirs": (vdir, (P, 3)),
            "incidents_shs": (shs, (P, 3 * N_SH))}


def shade_fwd(dirs, vis, area, gl, bc, rough, nrm, vdir, shs):
    """Launch K4-fwd on CUDA tensors in the kernel's layout
    (`kernel_inputs`): (pbr, diffuse_light, specular), each [P, 3]."""
    inputs = (dirs, vis, area, gl, bc, rough, nrm, vdir, shs)
    device = vis.device
    _build.check_tensors("K4-fwd", device, _expect(*inputs))
    P, S = vis.shape
    outs = [torch.empty((P, 3), dtype=torch.float32, device=device)
            for _ in range(3)]
    if P == 0:
        return tuple(outs)             # no point, no launch
    _K4_FWD(device, *inputs, P, S, *outs)
    return tuple(outs)


def shade_bwd(dirs, vis, area, gl, bc, rough, nrm, vdir, shs, g_pbr, g_dif,
              g_spec):
    """Launch K4-bwd on CUDA tensors: (d base_color [P, 3], d roughness [P],
    d viewdirs [P, 3], d shs [P, 48], d global_light [P, S, 3]) for the
    cotangents of (pbr, diffuse_light, specular)."""
    inputs = (dirs, vis, area, gl, bc, rough, nrm, vdir, shs)
    device = vis.device
    P, S = vis.shape
    expect = _expect(*inputs)
    expect.update({"g_pbr": (g_pbr, (P, 3)), "g_diffuse": (g_dif, (P, 3)),
                   "g_specular": (g_spec, (P, 3))})
    _build.check_tensors("K4-bwd", device, expect)
    shapes = ((P, 3), (P,), (P, 3), (P, 3 * N_SH), (P, S, 3))
    outs = [torch.empty(s, dtype=torch.float32, device=device) for s in shapes]
    if P == 0:
        return tuple(outs)             # no point, no launch
    # the points with a sample's local light near 0: count, then the points
    unsure = torch.empty((P + 1,), dtype=torch.int32, device=device)
    _K4_BWD(device, *inputs, g_pbr, g_dif, g_spec, P, S, *outs, unsure)
    return tuple(outs)

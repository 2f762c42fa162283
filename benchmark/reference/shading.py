"""Frozen copy of the port's `ops/shading.py`, for the benchmark's plain reference.

It imports nothing of the port; a change to the port does not reach it.

Per-point physically based shading (port of relightable3dgaussian_tpu/ops/shading.py).

`ggx_specular` and `rendering_equation` as torch ops:

  * incident light = max(SH(local incidents), 0) + visibility · env(global)
  * transport = light · area · max(n·i, 0)
  * diffuse f_d = albedo / π; specular f_s = GGX with the Schlick Fresnel
    2^((−5.55473 VoH − 6.98316) VoH), k = (α + 2r + 1)/8, denominator
    clamped to [1e-6, 4π]
  * pbr = mean over samples of (f_d + f_s) · transport

The stage-2 eval shades with it; with a precomputed light it is the plain
version of kernel K4 (ops/shading_cuda.py).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from .sh import eval_sh


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def ggx_specular(normal: torch.Tensor, pts2c: torch.Tensor,
                 pts2l: torch.Tensor, roughness: torch.Tensor,
                 fresnel: float = 0.04,
                 voh_pass: torch.Tensor | None = None) -> torch.Tensor:
    """GGX specular reflectance [P, S, 1] for normals [P, 3], view
    directions [P, 3], unit light directions [P, S, 3] and roughness
    [P, 1] (`voh_pass`: ggx_terms')."""
    return ggx_terms(normal, pts2c, pts2l, roughness, fresnel,
                     voh_pass)["f_s"]


def ggx_terms(normal: torch.Tensor, pts2c: torch.Tensor, pts2l: torch.Tensor,
              roughness: torch.Tensor, fresnel: float = 0.04,
              voh_pass: torch.Tensor | None = None) -> dict:
    """`ggx_specular`'s chain: f_s [P, S, 1] and the operands of its clips
    before they are clipped, NoV [P, 1] and NoH, VoH and the denominator q
    [P, S, 1], each of which the clip to [1e-6, ...] passes a gradient
    only at or above 1e-6 (kernel K4 decides the same clips in its own
    float32 rounding: ops/shading_cuda.py::k4_branch_operands).

    `voh_pass` [P, S, 1] (bool), where given, is VoH's lower-clip decision
    in place of this arithmetic's own: a reference that decides it past
    float64 (chip_smoke.py::reference_voh_pass). The value is continuous
    across the clip; only the gradient follows the decision."""
    L = pts2l
    V = _normalize(pts2c)
    H = _normalize((L + V[:, None, :]) / 2.0)
    N = _normalize(normal)
    N = N * torch.sign((V * N).sum(-1, keepdim=True))

    NoV_raw = (N * V).sum(-1, keepdim=True)                          # [P, 1]
    NoH_raw = (N[:, None] * H).sum(-1, keepdim=True)
    VoH_raw = (V[:, None] * H).sum(-1, keepdim=True)
    NoL = torch.clamp((N[:, None] * L).sum(-1, keepdim=True), 1e-6, 1.0)
    NoV = torch.clamp(NoV_raw, 1e-6, 1.0)
    NoH = torch.clamp(NoH_raw, 1e-6, 1.0)
    VoH = torch.clamp(VoH_raw, 1e-6, 1.0)
    if voh_pass is not None:
        VoH = torch.where(voh_pass, torch.clamp(VoH_raw, max=1.0),
                          VoH.detach())

    alpha = roughness * roughness
    alpha2 = alpha * alpha
    k = (alpha + 2 * roughness + 1.0) / 8.0
    FMi = ((-5.55473) * VoH - 6.98316) * VoH
    frac = (fresnel + (1 - fresnel) * torch.pow(2.0, FMi)) * alpha2[:, None]
    nom0 = NoH * NoH * (alpha2[:, None] - 1) + 1
    nom1 = NoV * (1 - k) + k
    nom2 = NoL * (1 - k[:, None]) + k[:, None]
    q = 4 * math.pi * nom0 * nom0 * nom1[:, None] * nom2
    return {"f_s": frac / torch.clamp(q, 1e-6, 4 * math.pi), "NoV": NoV_raw,
            "NoH": NoH_raw, "VoH": VoH_raw, "q": q}


def rendering_equation(base_color: torch.Tensor, roughness: torch.Tensor,
                       normals: torch.Tensor, viewdirs: torch.Tensor,
                       incidents_shs: torch.Tensor,
                       direct_light_fn: Callable[[torch.Tensor], torch.Tensor],
                       visibility: torch.Tensor, incident_dirs: torch.Tensor,
                       incident_areas: torch.Tensor,
                       voh_pass: torch.Tensor | None = None):
    """Shade every point from its cached incident samples.

    base_color [P, 3], roughness [P, 1], normals [P, 3], viewdirs [P, 3]
    (point → camera), incidents_shs [P, K, 3] local-light SH,
    direct_light_fn: dirs [P, S, 3] → radiance [P, S, 3], visibility
    [P, S, 1], incident_dirs [P, S, 3], incident_areas [P, S, 1].
    Returns (pbr [P, 3], extras) with the per-sample lights [P, S, 3] and
    the diffuse light and specular [P, 3]. `voh_pass`: ggx_terms'.
    """
    deg = int(math.isqrt(incidents_shs.shape[1]) - 1)
    global_light = direct_light_fn(incident_dirs) * visibility
    sh_cl = incidents_shs.transpose(-1, -2)[:, None]             # [P, 1, 3, K]
    # torch.maximum, as jnp.maximum, passes half the gradient at a tie: the
    # local-light SH start at zero in stage 2.
    zero = incident_dirs.new_zeros(())
    local_light = torch.maximum(eval_sh(deg, sh_cl, incident_dirs), zero)
    incident_lights = local_light + global_light

    n_d_i = torch.maximum((normals[:, None] * incident_dirs).sum(-1, keepdim=True),
                          zero)
    f_s = ggx_specular(normals, viewdirs, incident_dirs, roughness,
                       voh_pass=voh_pass)
    transport = incident_lights * (incident_areas * n_d_i)       # [P, S, 3]
    specular = (f_s * transport).mean(-2)
    diffuse_light = transport.mean(-2)
    # f_d is constant over S: mean((f_d + f_s) · transport) factors.
    pbr = base_color / math.pi * diffuse_light + specular
    extras = {
        "incident_lights": incident_lights,
        "local_incident_lights": local_light,
        "global_incident_lights": global_light,
        "diffuse_light": diffuse_light,
        "specular": specular,
    }
    return pbr, extras

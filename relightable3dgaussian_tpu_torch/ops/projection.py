"""Per-gaussian preprocessing (port of relightable3dgaussian_tpu/ops/projection.py).

`compute_cov2d` and `preprocess`, line for line: frustum cull at view z <= 0.2,
EWA Jacobian with view x/y clamped to 1.3·tan(fov), +0.3 px low-pass, radius
ceil(3·sqrt(λmax)), the alpha-aware tile rect when opacity is given, ndc→pixel
((x + 1)·size − 1)/2, and SH→RGB along (mean − campos), +0.5, clamped at
0, unless the caller gives the colours (`colors`) or the 3D covariances
(`cov3d_precomp`, packed or full) itself. `covariance3d_packed` is the
packed covariance the scales and rotations give.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.quaternions import (build_covariance, strip_symmetric,
                                 unpack_symmetric)
from ..utils import trace
from ..utils.sh import eval_sh
from .camera import CameraParams
from .config import RasterConfig


class Preprocessed(NamedTuple):
    mean2d: torch.Tensor      # [P, 2] pixel-space centers
    depth: torch.Tensor       # [P] view-space z (sort key)
    conic: torch.Tensor       # [P, 3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor      # [P] int32 screen radius (0 = culled)
    rgb: torch.Tensor         # [P, 3] SH-evaluated color
    rect_min: torch.Tensor    # [P, 2] int32 inclusive tile rect min (x, y)
    rect_max: torch.Tensor    # [P, 2] int32 exclusive tile rect max (x, y)
    tiles_touched: torch.Tensor  # [P] int32 number of covered tiles


def _homogeneous(means3d: torch.Tensor) -> torch.Tensor:
    return torch.cat([means3d, torch.ones_like(means3d[:, :1])], dim=-1)


def compute_cov2d(mean3d: torch.Tensor, cov3d: torch.Tensor,
                  cam: CameraParams) -> torch.Tensor:
    """EWA projection of [P, 3, 3] world covariances → packed [P, 3]
    (xx, xy, yy) screen covariance including the +0.3 low-pass."""
    t = _homogeneous(mean3d) @ cam.world_view
    tz = t[:, 2]
    limx = 1.3 * cam.tan_fov[0]
    limy = 1.3 * cam.tan_fov[1]
    tx = torch.minimum(torch.maximum(t[:, 0] / tz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(t[:, 1] / tz, -limy), limy) * tz

    fx, fy = cam.focal[0], cam.focal[1]
    zero = torch.zeros_like(tz)
    J = torch.stack(
        [
            torch.stack([fx / tz, zero, -(fx * tx) / (tz * tz)], -1),
            torch.stack([zero, fy / tz, -(fy * ty) / (tz * tz)], -1),
        ],
        dim=-2,
    )  # [P, 2, 3]
    R_w2c = cam.world_view[:3, :3].T   # world_view stores the transpose
    T = J @ R_w2c                      # [P, 2, 3]
    cov2d = T @ cov3d @ T.transpose(-1, -2)
    xx = cov2d[:, 0, 0] + 0.3
    yy = cov2d[:, 1, 1] + 0.3
    xy = cov2d[:, 0, 1]
    return torch.stack([xx, xy, yy], dim=-1)


def full_covariance(cov3d: torch.Tensor, n: int) -> torch.Tensor:
    """[n, 3, 3] from a packed [n, 6] (xx, xy, xz, yy, yz, zz), or a full
    [n, 3, 3] as it is; raises ValueError on any other shape."""
    shape = tuple(cov3d.shape)
    if shape == (n, 3, 3):
        return cov3d
    if shape == (n, 6):
        return unpack_symmetric(cov3d)
    raise ValueError(f"cov3d_precomp: got shape {shape}, expected [{n}, 6] "
                     f"(packed xx, xy, xz, yy, yz, zz) or [{n}, 3, 3]")


def preprocess(means3d: torch.Tensor, scales: torch.Tensor,
               rotations: torch.Tensor, shs: torch.Tensor, cam: CameraParams,
               cfg: RasterConfig,
               mean2d_offset: torch.Tensor | None = None,
               opacity: torch.Tensor | None = None,
               colors: torch.Tensor | None = None,
               cov3d_precomp: torch.Tensor | None = None) -> Preprocessed:
    """Project all gaussians; culled gaussians get radius 0.

    `mean2d_offset` ([P, 2], zeros) is added to the pixel-space means: its
    `.grad` is d(loss)/d(mean2d), the densification statistic (the
    reference's `screenspace_points`). When `opacity` ([P] activated) is
    given, the tile rect uses the tighter alpha-aware radius
    sqrt(2 λmax ln(255 op)); `radius` keeps the 3σ value. `colors` [P, 3]
    replaces the SH colour (`shs` may then be None) and `cov3d_precomp`
    the covariance of `scales` and `rotations` (then unused): packed
    [P, 6] (xx, xy, xz, yy, yz, zz), the reference's layout, or the full
    [P, 3, 3] the JAX package takes, used as it is (all nine entries, not
    symmetrized). Gradients reach the tensor given.
    """
    with trace.span("render.projection"):
        xyz1 = _homogeneous(means3d)
        p_view = xyz1 @ cam.world_view
        depth = p_view[:, 2]
        in_frustum = depth > 0.2

        p_hom = xyz1 @ cam.full_proj
        p_w = 1.0 / (p_hom[:, 3] + 1e-7)
        p_proj = p_hom[:, :3] * p_w[:, None]

        cov3d = (full_covariance(cov3d_precomp, means3d.shape[0])
                 if cov3d_precomp is not None
                 else build_covariance(scales, rotations, cfg.scale_modifier))
        cov2d = compute_cov2d(means3d, cov3d, cam)

        det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] ** 2
        det_ok = det != 0.0
        inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
        conic = torch.stack(
            [cov2d[:, 2] * inv_det, -cov2d[:, 1] * inv_det, cov2d[:, 0] * inv_det],
            dim=-1)

        mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
        gap = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        lambda1 = mid + gap
        radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))

        mean2d = torch.stack(
            [((p_proj[:, 0] + 1.0) * cfg.width - 1.0) * 0.5,
             ((p_proj[:, 1] + 1.0) * cfg.height - 1.0) * 0.5], dim=-1)
        if mean2d_offset is not None:
            mean2d = mean2d + mean2d_offset

        radius = torch.where(in_frustum & det_ok, radius_f, 0.0).to(torch.int32)

        # Tile rect (min inclusive, max exclusive), clamped to the tile grid.
        grid = torch.tensor([cfg.tiles_x, cfg.tiles_y], dtype=torch.int32,
                            device=means3d.device)
        trace.count("host.syncs")   # a pageable copy waits for the stream
        radius_f32 = radius.to(torch.float32)
        if opacity is not None:
            op = torch.clamp(opacity, min=0.0)
            # alpha = op * exp(-q/2) with q >= |d|^2 / λmax; alpha < 1/255
            # whenever |d| > sqrt(2 λmax ln(255 op)).
            r_alpha = torch.ceil(torch.sqrt(torch.clamp(
                2.0 * lambda1 * torch.log(torch.clamp(op, min=1e-12) * 255.0),
                min=0.0)))
            rect_radius = torch.where(op * 255.0 <= 1.0, 0.0,
                                      torch.minimum(radius_f32, r_alpha))
            rect_radius = torch.where(radius > 0, rect_radius, 0.0)
        else:
            rect_radius = radius_f32
        r = rect_radius[:, None].detach()
        m2d = mean2d.detach()
        # The int cast truncates toward zero (not floor), as in the JAX package.
        rect_min = torch.minimum(torch.clamp(
            ((m2d - r) / cfg.tile).to(torch.int32), min=0), grid)
        rect_max = torch.minimum(torch.clamp(
            torch.div(m2d + r + cfg.tile - 1, cfg.tile,
                      rounding_mode="floor").to(torch.int32), min=0), grid)
        spans = torch.clamp(rect_max - rect_min, min=0)
        tiles_touched = torch.where(radius > 0, spans[:, 0] * spans[:, 1], 0)
        # A gaussian whose rect is empty contributes nothing: zero its radius.
        radius = torch.where(tiles_touched > 0, radius, 0).to(torch.int32)

        if colors is not None:
            rgb = colors
        else:
            dirs = means3d - cam.campos[None, :]
            dirs = dirs / torch.clamp(
                torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
            # shs: [P, K, 3] → eval over the channel-last layout
            rgb = torch.clamp(
                eval_sh(cfg.sh_degree, shs.transpose(-1, -2), dirs) + 0.5, min=0.0)

        return Preprocessed(
            mean2d=mean2d,
            depth=depth,
            conic=conic,
            radius=radius,
            rgb=rgb,
            rect_min=rect_min,
            rect_max=rect_max,
            tiles_touched=tiles_touched.to(torch.int32),
        )


def covariance3d_packed(scales: torch.Tensor, rotations: torch.Tensor,
                        scale_modifier: float = 1.0) -> torch.Tensor:
    """Packed upper-triangular 3D covariance [P, 6] (xx, xy, xz, yy, yz,
    zz) of scales [P, 3] and rotations [P, 4]."""
    return strip_symmetric(build_covariance(scales, rotations, scale_modifier))

"""Per-gaussian preprocessing (port of relightable3dgaussian_tpu/ops/projection.py).

`compute_cov2d` and `preprocess_plain`, line for line: frustum cull at view
z <= 0.2, EWA Jacobian with view x/y clamped to 1.3·tan(fov), +0.3 px
low-pass, radius ceil(3·sqrt(λmax)), the alpha-aware tile rect when opacity
is given, ndc→pixel ((x + 1)·size − 1)/2, and SH→RGB along (mean − campos),
+0.5, clamped at 0, unless the caller gives the colours (`colors`) or the 3D
covariances (`cov3d_precomp`, packed or full) itself. `preprocess` runs it
on CPU tensors and kernel K7 (`ops/projection_cuda.py`) on CUDA tensors;
`projection_backward_plain` is K7's backward written out in plain PyTorch.
`covariance3d_packed` is the packed covariance the scales and rotations
give.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.quaternions import (build_covariance, quaternion_to_rotmat,
                                 strip_symmetric, unpack_symmetric)
from ..utils import trace
from ..utils.sh import C1, C2, C3, eval_sh, eval_sh_basis
from . import projection_cuda
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

    CPU tensors take `preprocess_plain`; CUDA tensors kernel K7
    (`ops/projection_cuda.py`: one forward launch, one backward), or an
    exception. Nothing falls back.
    """
    with trace.span("render.projection"):
        if means3d.device.type == "cpu":
            return preprocess_plain(means3d, scales, rotations, shs, cam, cfg,
                                    mean2d_offset, opacity, colors,
                                    cov3d_precomp)
        if means3d.device.type != "cuda":
            raise ValueError(f"preprocess: means3d on {means3d.device}; "
                             "expected the CPU or a CUDA device")
        return Preprocessed(*projection_cuda.project(
            means3d, scales, rotations, shs, cam, cfg, mean2d_offset,
            opacity, colors, cov3d_precomp))


def preprocess_plain(means3d: torch.Tensor, scales: torch.Tensor,
                     rotations: torch.Tensor, shs: torch.Tensor,
                     cam: CameraParams, cfg: RasterConfig,
                     mean2d_offset: torch.Tensor | None = None,
                     opacity: torch.Tensor | None = None,
                     colors: torch.Tensor | None = None,
                     cov3d_precomp: torch.Tensor | None = None
                     ) -> Preprocessed:
    """`preprocess`'s plain version, on any device and dtype: eager
    PyTorch, differentiable by autograd. CPU tensors take it; on the card
    it is K7's yardstick in tests and `chip_smoke.py`."""
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


def _clamp_slope(u: torch.Tensor, lim: torch.Tensor) -> torch.Tensor:
    """d/du of min(max(u, -lim), lim) as autograd takes it: 1 inside, 0
    outside, 1/2 at a tie (torch.maximum and torch.minimum split a tie's
    gradient)."""
    inner = torch.where(u > -lim, 1.0, torch.where(u == -lim, 0.5, 0.0))
    v = torch.maximum(u, -lim)
    return inner * torch.where(v < lim, 1.0, torch.where(v == lim, 0.5, 0.0))


def _normalize_backward(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient into v [P, n] of v / clamp(|v|, min=1e-12) for the
    output gradient g: the norm's term only where |v| >= 1e-12 (the clamp's
    gradient passes a tie)."""
    n = torch.linalg.norm(v, dim=-1)
    c = torch.clamp(n, min=1e-12)
    g_c = -(g * v).sum(-1) / (c * c)
    return g / c[:, None] + torch.where(n >= 1e-12, g_c / n, 0.0)[:, None] * v


def sh_basis_jacobian(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """[P, (deg+1)², 3]: d(basis_k)/d(x, y, z) of `eval_sh_basis`, degree
    0 to 3, at directions [P, 3]."""
    if not 0 <= deg <= 3:
        raise ValueError(f"SH degree {deg}: the projection takes 0 to 3")
    x, y, z = dirs.unbind(-1)
    o = torch.zeros_like(x)
    rows = [(o, o, o)]
    if deg > 0:
        rows += [(o, -C1 + o, o), (o, o, C1 + o), (-C1 + o, o, o)]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        rows += [(C2[0] * y, C2[0] * x, o), (o, C2[1] * z, C2[1] * y),
                 (-2 * C2[2] * x, -2 * C2[2] * y, 4 * C2[2] * z),
                 (C2[3] * z, o, C2[3] * x), (2 * C2[4] * x, -2 * C2[4] * y, o)]
    if deg > 2:
        rows += [
            (6 * C3[0] * x * y, C3[0] * (3 * xx - 3 * yy), o),
            (C3[1] * y * z, C3[1] * x * z, C3[1] * x * y),
            (-2 * C3[2] * x * y, C3[2] * (4 * zz - xx - 3 * yy),
             8 * C3[2] * y * z),
            (-6 * C3[3] * x * z, -6 * C3[3] * y * z,
             C3[3] * (6 * zz - 3 * xx - 3 * yy)),
            (C3[4] * (4 * zz - 3 * xx - yy), -2 * C3[4] * x * y,
             8 * C3[4] * x * z),
            (2 * C3[5] * x * z, -2 * C3[5] * y * z, C3[5] * (xx - yy)),
            (C3[6] * (3 * xx - 3 * yy), -6 * C3[6] * x * y, o)]
    return torch.stack([torch.stack(r, -1) for r in rows], 1)


def projection_backward_plain(means3d, scales, rotations, shs,
                              cam: CameraParams, cfg: RasterConfig,
                              g_mean2d, g_depth, g_conic, g_rgb,
                              colors=None, cov3d_precomp=None) -> tuple:
    """K7's backward formulas, written out in plain PyTorch: the gradients
    of `preprocess_plain`'s inputs for the gradients of its outputs mean2d
    [P, 2], depth [P], conic [P, 3] and rgb [P, 3] (None where the output
    feeds nothing; rgb's is not read when `colors` is given). Returns
    (means3d, scales, rotations, shs, cov3d_precomp)'s, None for an input
    not given or not used; the SH coefficients beyond the active degree get
    0. mean2d_offset's and colors' gradients are the incoming mean2d's and
    rgb's, so they are not returned.

    The kernel's specification, for the tests alone: every
    gaussian is differentiated as autograd differentiates the plain
    version, culled or not, through the same clamps (the EWA Jacobian's
    x/y clamp with autograd's half slope at a tie, the conic's det != 0,
    the colour's clamp at 0 passing a tie, the normalisations' 1e-12)."""
    P = means3d.shape[0]
    zero = means3d.new_zeros((P,))
    g_mean2d = means3d.new_zeros((P, 2)) if g_mean2d is None else g_mean2d
    g_depth = zero if g_depth is None else g_depth
    g_conic = means3d.new_zeros((P, 3)) if g_conic is None else g_conic
    wv, fp = cam.world_view, cam.full_proj
    xyz1 = _homogeneous(means3d)
    t = xyz1 @ wv
    t0, t1, tz = t[:, 0], t[:, 1], t[:, 2]
    h = xyz1 @ fp
    p_w = 1.0 / (h[:, 3] + 1e-7)

    # mean2d = ((h_j p_w + 1) size - 1) / 2
    g_p0 = g_mean2d[:, 0] * 0.5 * cfg.width
    g_p1 = g_mean2d[:, 1] * 0.5 * cfg.height
    g_pw = g_p0 * h[:, 0] + g_p1 * h[:, 1]
    g_h = torch.stack([g_p0 * p_w, g_p1 * p_w, zero, -g_pw * p_w * p_w], -1)
    g_m = g_h @ fp[:3].T

    # the EWA Jacobian J, T = J W and cov2d = T Σ Tᵀ
    fx, fy = cam.focal[0], cam.focal[1]
    limx, limy = 1.3 * cam.tan_fov[0], 1.3 * cam.tan_fov[1]
    ux, uy = t0 / tz, t1 / tz
    cx = torch.minimum(torch.maximum(ux, -limx), limx)
    cy = torch.minimum(torch.maximum(uy, -limy), limy)
    tx, ty = cx * tz, cy * tz
    d = tz * tz
    J = torch.stack([torch.stack([fx / tz, zero, -(fx * tx) / d], -1),
                     torch.stack([zero, fy / tz, -(fy * ty) / d], -1)], -2)
    W = wv[:3, :3].T
    Tm = J @ W
    sigma = (full_covariance(cov3d_precomp, P) if cov3d_precomp is not None
             else build_covariance(scales, rotations, cfg.scale_modifier))
    M = Tm @ sigma
    C = M @ Tm.transpose(-1, -2)
    xx, xy, yy = C[:, 0, 0] + 0.3, C[:, 0, 1], C[:, 1, 1] + 0.3
    det = xx * yy - xy * xy
    ok = det != 0.0
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    ga, gb, gc = g_conic.unbind(-1)
    g_inv = ga * yy - gb * xy + gc * xx
    g_det = torch.where(ok, -g_inv * inv * inv, 0.0)
    g_xx = gc * inv + g_det * yy
    g_yy = ga * inv + g_det * xx
    g_xy = -gb * inv - g_det * 2 * xy
    G = torch.stack([torch.stack([g_xx, g_xy], -1),
                     torch.stack([zero, g_yy], -1)], -2)
    g_M = G @ Tm
    g_T = G.transpose(-1, -2) @ M + g_M @ sigma.transpose(-1, -2)
    g_sigma = Tm.transpose(-1, -2) @ g_M
    g_J = g_T @ W.T
    g_nx, g_ny = g_J[:, 0, 2] / d, g_J[:, 1, 2] / d
    g_d = -g_J[:, 0, 2] * (-(fx * tx)) / (d * d) \
        - g_J[:, 1, 2] * (-(fy * ty)) / (d * d)
    g_tx, g_ty = -g_nx * fx, -g_ny * fy
    g_tz = (g_J[:, 0, 0] * (-fx / d) + g_J[:, 1, 1] * (-fy / d)
            + g_d * 2 * tz + g_tx * cx + g_ty * cy + g_depth)
    g_ux = g_tx * tz * _clamp_slope(ux, limx)
    g_uy = g_ty * tz * _clamp_slope(uy, limy)
    g_tz = g_tz - g_ux * t0 / d - g_uy * t1 / d
    g_t = torch.stack([g_ux / tz, g_uy / tz, g_tz], -1)
    g_m = g_m + g_t @ wv[:3, :3].T

    g_scales = g_rot = g_cov = None
    if cov3d_precomp is not None:
        g_cov = g_sigma
        if cov3d_precomp.dim() == 2:
            s = g_sigma + g_sigma.transpose(-1, -2)
            g_cov = torch.stack([g_sigma[:, 0, 0], s[:, 0, 1], s[:, 0, 2],
                                 g_sigma[:, 1, 1], s[:, 1, 2],
                                 g_sigma[:, 2, 2]], -1)
    else:
        n = torch.linalg.norm(rotations, dim=-1, keepdim=True)
        q = rotations / torch.clamp(n, min=1e-12)
        R = quaternion_to_rotmat(q)
        ss = cfg.scale_modifier * scales
        L = R * ss[:, None, :]
        g_L = (g_sigma + g_sigma.transpose(-1, -2)) @ L
        g_scales = (g_L * R).sum(1) * cfg.scale_modifier
        gR = g_L * ss[:, None, :]
        r, x, y, z = q.unbind(-1)
        g = [[gR[:, i, j] for j in range(3)] for i in range(3)]
        g_q = 2 * torch.stack([
            -z * g[0][1] + y * g[0][2] + z * g[1][0] - x * g[1][2]
            - y * g[2][0] + x * g[2][1],
            y * g[0][1] + z * g[0][2] + y * g[1][0] - 2 * x * g[1][1]
            - r * g[1][2] + z * g[2][0] + r * g[2][1] - 2 * x * g[2][2],
            -2 * y * g[0][0] + x * g[0][1] + r * g[0][2] + x * g[1][0]
            + z * g[1][2] - r * g[2][0] + z * g[2][1] - 2 * y * g[2][2],
            -2 * z * g[0][0] - r * g[0][1] + x * g[0][2] + r * g[1][0]
            - 2 * z * g[1][1] + y * g[1][2] + x * g[2][0] + y * g[2][1]], -1)
        g_rot = _normalize_backward(rotations, g_q)

    g_shs = None
    if colors is None:
        deg = cfg.sh_degree
        ncoef = (deg + 1) ** 2
        v = means3d - cam.campos[None, :]
        dirs = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                               min=1e-12)
        coef = shs[:, :ncoef]
        basis = eval_sh_basis(deg, dirs)
        val = (basis[:, :, None] * coef).sum(1) + 0.5
        g_raw = (torch.zeros_like(val) if g_rgb is None
                 else torch.where(val >= 0.0, g_rgb, 0.0))
        g_shs = torch.zeros_like(shs)
        g_shs[:, :ncoef] = basis[:, :, None] * g_raw[:, None, :]
        g_dir = ((coef * g_raw[:, None, :]).sum(-1)[:, :, None]
                 * sh_basis_jacobian(deg, dirs)).sum(1)
        g_m = g_m + _normalize_backward(v, g_dir)
    return g_m, g_scales, g_rot, g_shs, g_cov


def covariance3d_packed(scales: torch.Tensor, rotations: torch.Tensor,
                        scale_modifier: float = 1.0) -> torch.Tensor:
    """Packed upper-triangular 3D covariance [P, 6] (xx, xy, xz, yy, yz,
    zz) of scales [P, 3] and rotations [P, 4]."""
    return strip_symmetric(build_covariance(scales, rotations, scale_modifier))

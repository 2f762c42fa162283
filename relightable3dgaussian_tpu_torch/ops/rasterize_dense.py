"""Dense oracle rasterizer (port of
relightable3dgaussian_tpu/ops/rasterize_dense.py).

Exact O(P · pixels) alpha compositing, the correctness reference for the
tiled pipeline (ops/rasterize.py): every gaussian is blended against every
pixel in global depth order under the CUDA reference's skip rules
(forward.cu:300-384):
  * candidates are gaussians with radius > 0 whose tile rect covers the pixel;
  * skip where power > 0 or alpha < 1/255; alpha is capped at 0.99;
  * blend while the incoming transmittance T >= 1e-4 (sticky, as T only
    falls), the rule the tiled compositors use too.

The JAX package walks the gaussians in a `lax.scan`; here the walk is
vectorised: the T before each gaussian is the exclusive cumulative product
of (1 − α) over the depth-sorted gaussians (1 − α >= 0.01, so no factor
is zero), and the blend is one [pixels, P] × [P, A] product. That rounds the
products and sums in another order than the scan. Plain torch with
autograd, in the dtype of `means3d` (float32 or float64) on its device, the
projection included (`preprocess_plain` on every device, never the card's
kernel); for tests and chip_smoke at small P and images, never on a main
path.
"""
from __future__ import annotations

import torch

from .camera import CameraParams
from .config import RasterConfig
from .projection import Preprocessed, preprocess_plain
from .rasterize import RasterOut
from .surface import pseudo_normal_from_depth


def _alpha_at(prep: Preprocessed, px: torch.Tensor, py: torch.Tensor,
              opacity: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """[P, N] alpha of P gaussians at N pixels (px, py [N]), zero where the
    reference skips the pair."""
    dx = prep.mean2d[:, 0:1] - px[None, :]
    dy = prep.mean2d[:, 1:2] - py[None, :]
    con = prep.conic
    power = (-0.5 * (con[:, 0:1] * dx * dx + con[:, 2:3] * dy * dy)
             - con[:, 1:2] * dx * dy)
    alpha = torch.clamp(
        opacity[:, None] * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
    ok = (power <= 0.0) & (alpha >= 1.0 / 255.0)
    # The tile-rect coverage test: a gaussian blends only in tiles of its rect.
    tx = torch.div(px, cfg.tile, rounding_mode="floor").int()[None, :]
    ty = torch.div(py, cfg.tile, rounding_mode="floor").int()[None, :]
    in_rect = ((tx >= prep.rect_min[:, 0:1]) & (tx < prep.rect_max[:, 0:1])
               & (ty >= prep.rect_min[:, 1:2]) & (ty < prep.rect_max[:, 1:2]))
    ok = ok & in_rect & (prep.radius > 0)[:, None]
    return torch.where(ok, alpha, 0.0)


def rasterize_dense(means3d, scales, rotations, opacity, shs, features,
                    cam: CameraParams, cfg: RasterConfig,
                    bg_color: torch.Tensor, colors_precomp=None,
                    cov3d_precomp=None) -> RasterOut:
    """Rasterize P gaussians over the whole image densely.

    Arguments as `ops.rasterize.rasterize`: means3d [P, 3]; scales [P, 3];
    rotations [P, 4]; opacity [P, 1] activated; shs [P, K, 3] (or None with
    colors_precomp [P, 3]); features [P, S]; bg_color [3]; cov3d_precomp
    packed [P, 6] or full [P, 3, 3]. The camera is taken in the dtype of
    `means3d`.
    """
    dtype, dev = means3d.dtype, means3d.device
    cam = CameraParams(*(t.to(dtype) for t in cam))
    P = means3d.shape[0]
    H, W = cfg.height, cfg.width
    prep = preprocess_plain(means3d, scales, rotations, shs, cam, cfg,
                            colors=colors_precomp,
                            cov3d_precomp=cov3d_precomp)

    order = torch.argsort(prep.depth.detach(), stable=True)
    sorted_prep = Preprocessed(*(t[order] for t in prep))
    px = torch.arange(W, dtype=dtype, device=dev).repeat(H)
    py = torch.arange(H, dtype=dtype, device=dev).repeat_interleave(W)
    alpha = _alpha_at(sorted_prep, px, py, opacity[order, 0], cfg)   # [P, N]

    one_minus = 1.0 - alpha
    through = torch.cumprod(one_minus, dim=0)          # T after each gaussian
    T = torch.cat([torch.ones_like(through[:1]), through[:-1]])
    w = torch.where(T >= 1e-4, alpha * T, 0.0)          # [P, N]
    final_T = through[-1] if P else torch.ones_like(px)

    attrs = torch.cat([prep.rgb, features, prep.depth[:, None],
                       torch.ones((P, 1), dtype=dtype, device=dev)], dim=-1)
    accum = w.transpose(0, 1) @ attrs[order]            # [N, A]
    A = attrs.shape[-1]
    S = features.shape[-1]
    weights = torch.zeros((P,), dtype=dtype, device=dev).index_put(
        (order,), w.sum(-1))

    rgb = accum[:, :3] + final_T[:, None] * bg_color.to(dtype)[None, :]
    color = rgb.transpose(0, 1).reshape(3, H, W)
    feature = accum[:, 3:3 + S].transpose(0, 1).reshape(S, H, W)
    depth_img = accum[:, A - 2].reshape(1, H, W)
    opacity_img = accum[:, A - 1].reshape(1, H, W)
    if cfg.compute_pseudo_normal:
        # Opacity-normalized depth (forward.cu:420 of the CUDA reference).
        depth_n = depth_img[0] / torch.clamp(opacity_img[0], min=1e-7)
        surface, pseudo = pseudo_normal_from_depth(depth_n, cam)
    else:
        surface = torch.zeros((3, H, W), dtype=dtype, device=dev)
        pseudo = torch.zeros_like(surface)
    return RasterOut(
        color=color,
        opacity=opacity_img,
        depth=depth_img,
        feature=feature,
        pseudo_normal=pseudo,
        surface_xyz=surface,
        weights=weights[:, None],
        radii=prep.radius,
        n_contrib=(w > 0).sum(0).to(torch.int32).reshape(H, W),
        num_rendered=int(prep.tiles_touched.sum()),
        final_T=final_T.reshape(H, W),
    )

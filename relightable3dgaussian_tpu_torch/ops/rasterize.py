"""Tiled rasterizer (port of relightable3dgaussian_tpu/ops/rasterize.py::rasterize).

preprocess (projection) → bin_gaussians (pairs sorted by tile and depth) →
tile compositor → image assembly + pseudo-normal pass. The compositor is the
plain PyTorch version on CPU tensors and kernel K1 on CUDA tensors
(ops/composite_cuda.py), never anything else. Returns the JAX package's
`RasterOut` fields (ops/rasterize_dense.py); `overflow_*` are always 0
because the port never drops a pair.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import composite_cuda
from .camera import CameraParams
from .composite import tiles_to_image
from .config import RasterConfig
from .projection import preprocess
from .surface import pseudo_normal_from_depth
from .tiles import bin_gaussians


class RasterOut(NamedTuple):
    color: torch.Tensor          # [3, H, W] (bg-composited)
    opacity: torch.Tensor        # [1, H, W]
    depth: torch.Tensor          # [1, H, W] raw alpha-weighted depth
    feature: torch.Tensor        # [S, H, W]
    pseudo_normal: torch.Tensor  # [3, H, W]
    surface_xyz: torch.Tensor    # [3, H, W]
    weights: torch.Tensor        # [P, 1] accumulated per-gaussian blend weight
    radii: torch.Tensor          # [P] int32
    n_contrib: torch.Tensor      # [H, W] int32 number of blended gaussians
    num_rendered: int            # (gaussian, tile) pairs
    final_T: torch.Tensor        # [H, W] final transmittance
    overflow_pairs: int = 0
    overflow_chunks: int = 0


def prepare(means3d, scales, rotations, opacity, shs, features,
            cam: CameraParams, cfg: RasterConfig):
    """Everything before the compositor: (Preprocessed, Binning, attrs
    [P, A]) with the attribute layout [rgb, features, depth, 1]."""
    P = means3d.shape[0]
    # Opacity drives the alpha-aware rect and the exact per-tile cull; the
    # cull decisions are integer selections, so detach it there.
    op_cull = opacity[:, 0].detach()
    prep = preprocess(means3d, scales, rotations, shs, cam, cfg,
                      opacity=op_cull)
    binning = bin_gaussians(prep, cfg, op_cull)
    attrs = torch.cat(
        [prep.rgb, features, prep.depth[:, None],
         torch.ones((P, 1), dtype=means3d.dtype, device=means3d.device)],
        dim=-1)
    return prep, binning, attrs


def rasterize(means3d, scales, rotations, opacity, shs, features,
              cam: CameraParams, cfg: RasterConfig,
              bg_color: torch.Tensor) -> RasterOut:
    """Rasterize P gaussians.

    Args:
      means3d: [P, 3]; scales: [P, 3]; rotations: [P, 4] quaternions;
      opacity: [P, 1] activated; shs: [P, K, 3]; features: [P, S] extra
      blended channels. All tensors, the camera's included, on one device.
      On CUDA tensors the compositor is forward only: run under
      `torch.no_grad()` (or `torch.inference_mode()`), since inputs that
      require grad raise NotImplementedError.
    """
    H, W = cfg.height, cfg.width
    prep, binning, attrs = prepare(
        means3d, scales, rotations, opacity, shs, features, cam, cfg)
    out = composite_cuda.composite(
        binning, prep.mean2d.contiguous(), prep.conic.contiguous(),
        opacity[:, 0].contiguous(), attrs.contiguous(), cfg)

    img = tiles_to_image(out.image, cfg)        # [A, H, W]
    S = features.shape[-1]
    rgb = img[:3]
    feature = img[3:3 + S]
    depth = img[3 + S:4 + S]
    opac = img[4 + S:5 + S]
    color = rgb + (1.0 - opac) * bg_color[:, None, None]

    n_contrib = tiles_to_image(out.n_contrib[..., None], cfg)[0]

    if cfg.compute_pseudo_normal:
        # Opacity-normalized depth (forward.cu:420 of the CUDA reference).
        depth_n = depth[0] / torch.clamp(opac[0], min=1e-7)
        surface, pseudo = pseudo_normal_from_depth(depth_n, cam)
    else:
        surface = torch.zeros((3, H, W), dtype=means3d.dtype,
                              device=means3d.device)
        pseudo = torch.zeros_like(surface)

    return RasterOut(
        color=color,
        opacity=opac,
        depth=depth,
        feature=feature,
        pseudo_normal=pseudo,
        surface_xyz=surface,
        weights=out.weights[:, None],
        radii=prep.radius,
        n_contrib=n_contrib,
        num_rendered=binning.num_rendered,
        final_T=1.0 - opac[0],
    )

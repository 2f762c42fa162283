"""Stage-1 render, forward only (port of relightable3dgaussian_tpu/models/render.py).

`render_view` splats color plus the features [normal, depth²] (depth itself
rides the rasterizer's own depth channel, so A = 3 + 4 + 1 + 1 = 9), derives
the alpha-normalized maps and depth variance, and returns the JAX package's
result keys. `calculate_loss` comes with the training slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..ops.camera import CameraParams
from ..ops.config import RasterConfig
from ..ops.rasterize import rasterize
from .gaussians import GaussianModel


class ViewInputs(NamedTuple):
    """Per-view data on the model's device."""
    cam: CameraParams
    image: torch.Tensor        # [3, H, W] GT
    image_mask: torch.Tensor   # [1, H, W]
    depth: torch.Tensor        # [1, H, W] MVS depth (zeros if absent)
    normal: torch.Tensor       # [3, H, W] MVS normal (zeros if absent)


def view_features(model: GaussianModel, cam: CameraParams) -> torch.Tensor:
    """[P, 4] blended features [normal, depth²] of the stage-1 render."""
    xyz1 = torch.cat([model.xyz, torch.ones_like(model.xyz[:, :1])], dim=-1)
    depths = (xyz1 @ cam.world_view)[:, 2:3]
    return torch.cat([model.get_normal, depths ** 2], dim=-1)


def render_view(model: GaussianModel, cam: CameraParams, cfg: RasterConfig,
                bg_color: torch.Tensor) -> dict[str, Any]:
    """Splat the scene for one view; returns the reference results dict.

    On the card this slice is forward only: a model's parameters require
    grad, so call it under `torch.no_grad()` or `torch.inference_mode()`;
    otherwise the compositor raises NotImplementedError (its backward
    kernel comes with the training slice). On the CPU autograd works.
    """
    out = rasterize(
        model.xyz, model.get_scaling, model.get_rotation, model.get_opacity,
        model.get_shs, view_features(model, cam), cam=cam, cfg=cfg,
        bg_color=bg_color)

    mask = (out.n_contrib > 0)[None].to(out.feature.dtype)
    feat = out.feature / torch.clamp(out.opacity, min=1e-5) * mask
    r_normal, r_depth2 = feat[:3], feat[3:4]
    r_depth = out.depth / torch.clamp(out.opacity, min=1e-5) * mask
    depth_var = r_depth2 - r_depth ** 2

    dir_pp = model.xyz - cam.campos[None, :]
    dir_pp = dir_pp / torch.clamp(
        torch.linalg.norm(dir_pp, dim=-1, keepdim=True), min=1e-12)

    return {
        "render": out.color,
        "opacity": out.opacity,
        "depth": r_depth,
        "depth_var": depth_var,
        "normal": r_normal,
        "pseudo_normal": out.pseudo_normal,
        "surface_xyz": out.surface_xyz,
        "visibility_filter": out.radii > 0,
        "radii": out.radii,
        "num_rendered": out.num_rendered,
        "num_contrib": out.n_contrib,
        "opacities": model.get_opacity,
        "normals": model.get_normal,
        "directions": dir_pp,
        "weights": out.weights,
        "raw_depth": out.depth,
        "overflow_pairs": out.overflow_pairs,
        "overflow_chunks": out.overflow_chunks,
    }


def render(view: ViewInputs, model: GaussianModel, cfg: RasterConfig,
           bg_color: torch.Tensor) -> dict[str, Any]:
    """Stage-1 entry point (the JAX `render` with is_training=False). On
    CUDA tensors call it under `torch.no_grad()`; see `render_view`."""
    return render_view(model, view.cam, cfg, bg_color)

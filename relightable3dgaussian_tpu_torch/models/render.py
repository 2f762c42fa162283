"""Stage-1 render and loss (port of relightable3dgaussian_tpu/models/render.py).

`render_view` splats color plus the features [normal, depth²] (depth itself
rides the rasterizer's own depth channel, so A = 3 + 4 + 1 + 1 = 9), derives
the alpha-normalized maps and depth variance, and returns the JAX package's
result keys. `calculate_loss` is the stage-1 loss with every term of the JAX
package. It is differentiable on both devices: on the card the compositor's
backward is kernel K2. The JAX package's seeded-weights path (`w_seed`) is a
TPU scatter workaround and is not ported: the weights come from the forward.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import losses
from ..ops.camera import CameraParams
from ..ops.config import RasterConfig
from ..ops.rasterize import rasterize
from ..train.config import OptimizationConfig
from ..utils import trace
from ..utils.image import psnr
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
                bg_color: torch.Tensor,
                mean2d_offset: torch.Tensor | None = None,
                override_color: torch.Tensor | None = None) -> dict[str, Any]:
    """Splat the scene for one view; returns the reference results dict.
    `mean2d_offset` ([P, 2] zeros) collects d(loss)/d(mean2d) in `.grad`;
    `override_color` [P, 3] is splatted in place of the SH colour."""
    out = rasterize(
        model.xyz, model.get_scaling, model.get_rotation, model.get_opacity,
        model.get_shs, view_features(model, cam), cam=cam, cfg=cfg,
        bg_color=bg_color, mean2d_offset=mean2d_offset,
        colors_precomp=override_color)

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


def calculate_loss(view: ViewInputs, model: GaussianModel,
                   results: dict[str, Any], opt: OptimizationConfig,
                   iteration: int):
    """Stage-1 loss (the reference's gaussian_renderer/render.py:136-223):
    returns (loss, tb_dict of scalar tensors)."""
    with trace.span("train.loss"):
        tb = {}
        rendered = results["render"]
        gt = view.image
        n_pts = max(model.num_points, 1)

        ll1 = losses.l1_loss(rendered, gt)
        ssim_val = losses.ssim(rendered, gt)
        tb["loss_l1"] = ll1
        tb["psnr"] = psnr(rendered[None], gt[None]).mean()
        tb["ssim"] = ssim_val
        loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1.0 - ssim_val)

        if opt.lambda_mask_entropy > 0:
            le = losses.mask_entropy_loss(results["opacity"], view.image_mask)
            tb["loss_mask_entropy"] = le
            loss = loss + opt.lambda_mask_entropy * le

        if opt.lambda_normal_render_depth > 0:
            ln = losses.mse_loss(results["normal"] * view.image_mask,
                                 results["pseudo_normal"].detach()
                                 * view.image_mask)
            tb["loss_normal_render_depth"] = ln
            loss = loss + opt.lambda_normal_render_depth * ln

        if opt.lambda_normal_smooth > 0:
            ls = losses.first_order_edge_aware_loss(results["normal"], gt)
            tb["loss_normal_smooth"] = ls
            loss = loss + opt.lambda_normal_smooth * ls

        if opt.lambda_depth_smooth > 0:
            ld = losses.first_order_edge_aware_loss(results["depth"], gt)
            tb["loss_depth_smooth"] = ld
            loss = loss + opt.lambda_depth_smooth * ld

        if opt.lambda_point_entropy > 0:
            ws = results["weights"]
            op = results["opacities"]
            pe = (ws * (-op * torch.log(op + 1e-10)
                        - (1 - op) * torch.log(1 - op + 1e-10))).sum() / n_pts
            tb["loss_point_entropy"] = pe
            loss = loss + opt.lambda_point_entropy * pe

        if opt.lambda_orientation > 0:
            ws = torch.clamp(results["weights"], max=1.0)
            ori = (ws * torch.clamp(
                (results["normals"] * results["directions"]).sum(-1, keepdim=True),
                min=0.0)).sum() / n_pts
            gate = float(iteration > opt.lambda_orientation_from_iter)
            tb["loss_orientation"] = ori
            loss = loss + opt.lambda_orientation * gate * ori

        if opt.lambda_depth_var > 0:
            lv = torch.sqrt(torch.clamp(results["depth_var"], min=1e-6)).mean()
            ramp = min(10.0 ** (iteration / float(opt.depth_var_ramp_iters)), 100.0)
            tb["loss_depth_var"] = lv
            loss = loss + opt.lambda_depth_var * ramp * lv

        if opt.lambda_surface > 0:
            # per-coordinate median (the mean of the middle two for even counts)
            center = torch.quantile(model.xyz, 0.5, dim=0)
            ls = torch.exp(-(model.xyz - center[None]).abs().sum() / (3 * n_pts))
            tb["loss_surface"] = ls
            loss = loss + opt.lambda_surface * ls

        if opt.lambda_scaling > 0:
            scaling = model.get_scaling
            iso = (scaling - scaling.mean(-1, keepdim=True)).abs().sum() / n_pts
            lam = opt.lambda_scaling * (
                1.0 - 0.99 * min(1.0, 4.0 * iteration / opt.iterations))
            tb["loss_scaling"] = iso
            loss = loss + lam * iso

        tb["loss"] = loss
        return loss, tb


def render(view: ViewInputs, model: GaussianModel, cfg: RasterConfig,
           bg_color: torch.Tensor, opt: OptimizationConfig | None = None,
           is_training: bool = False, iteration: int = 0,
           mean2d_offset: torch.Tensor | None = None) -> dict[str, Any]:
    """Stage-1 entry point (the reference's `render`); with `is_training`
    the results also hold "loss" and "tb_dict"."""
    if is_training and opt is None:
        raise ValueError("render: is_training needs an OptimizationConfig")
    with trace.span("render.view", unit=True):
        results = render_view(model, view.cam, cfg, bg_color, mean2d_offset)
        if is_training:
            results["loss"], results["tb_dict"] = calculate_loss(
                view, model, results, opt, iteration)
        return results

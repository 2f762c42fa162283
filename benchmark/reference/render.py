"""The reference's rasterizer and stage-1 render and loss: plain PyTorch,
in the dtype of its inputs (float64 for the reference, float32 for its
control), after the port's `ops/rasterize.py` and `models/render.py`.

The compositor is the frozen plain one (`composite.py`) behind an autograd
function whose backward recomputes one tile batch at a time
(`composite_backward`), so an 800 x 800 view of a few hundred thousand
gaussians fits in float64. Imports nothing of the port.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from . import losses
from .camera import CameraParams
from .composite import composite, composite_backward, tiles_to_image
from .config import RasterConfig
from .projection import preprocess
from .surface import pseudo_normal_from_depth
from .tiles import Binning, bin_gaussians


def act_scaling(p) -> torch.Tensor:
    return torch.exp(p["scaling"])


def act_opacity(p) -> torch.Tensor:
    return torch.sigmoid(p["opacity"])


def act_rotation(p) -> torch.Tensor:
    q = p["rotation"]
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)


def act_normal(p) -> torch.Tensor:
    n = p["normal"]
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-3)


def act_shs(p) -> torch.Tensor:
    return torch.cat([p["shs_dc"], p["shs_rest"]], dim=1)


class _Composite(torch.autograd.Function):
    """The plain compositor with a batch-wise backward: (image, weights,
    n_contrib) of `composite`; image and weights are differentiable."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, attrs, binning: Binning,
                cfg: RasterConfig):
        with torch.no_grad():
            out = composite(binning, mean2d, conic, opacity, attrs, cfg)
        ctx.save_for_backward(mean2d, conic, opacity, attrs)
        ctx.binning, ctx.cfg = binning, cfg
        ctx.mark_non_differentiable(out.n_contrib)
        return out.image, out.weights, out.n_contrib

    @staticmethod
    def backward(ctx, g_image, g_weights, _g_count):
        mean2d, conic, opacity, attrs = ctx.saved_tensors
        grads = composite_backward(ctx.binning, mean2d, conic, opacity, attrs,
                                   g_image.contiguous(), g_weights, ctx.cfg)
        return (*grads, None, None)


class RasterOut(NamedTuple):
    color: torch.Tensor
    opacity: torch.Tensor
    depth: torch.Tensor
    feature: torch.Tensor
    pseudo_normal: torch.Tensor
    surface_xyz: torch.Tensor
    weights: torch.Tensor
    radii: torch.Tensor
    n_contrib: torch.Tensor
    num_rendered: int


def prepare(means3d, scales, rotations, opacity, shs, features,
            cam: CameraParams, cfg: RasterConfig, mean2d_offset=None):
    """Projection and binning: (Preprocessed, Binning, attrs [P, A]) with
    the attribute layout [rgb, features, depth, 1]."""
    P = means3d.shape[0]
    op_cull = opacity[:, 0].detach()
    prep = preprocess(means3d, scales, rotations, shs, cam, cfg,
                      mean2d_offset=mean2d_offset, opacity=op_cull)
    binning = bin_gaussians(prep, cfg, op_cull)
    attrs = torch.cat(
        [prep.rgb, features, prep.depth[:, None],
         torch.ones((P, 1), dtype=means3d.dtype, device=means3d.device)],
        dim=-1)
    return prep, binning, attrs


def rasterize(means3d, scales, rotations, opacity, shs, features,
              cam: CameraParams, cfg: RasterConfig, bg_color: torch.Tensor,
              mean2d_offset=None) -> RasterOut:
    prep, binning, attrs = prepare(means3d, scales, rotations, opacity, shs,
                                   features, cam, cfg, mean2d_offset)
    image, weights, n_contrib = _Composite.apply(
        prep.mean2d.contiguous(), prep.conic.contiguous(),
        opacity[:, 0].contiguous(), attrs.contiguous(), binning, cfg)
    img = tiles_to_image(image, cfg)
    S = features.shape[-1]
    rgb, feature = img[:3], img[3:3 + S]
    depth, opac = img[3 + S:4 + S], img[4 + S:5 + S]
    color = rgb + (1.0 - opac) * bg_color[:, None, None]
    n_contrib = tiles_to_image(n_contrib[..., None], cfg)[0]
    depth_n = depth[0] / torch.clamp(opac[0], min=1e-7)
    surface, pseudo = pseudo_normal_from_depth(depth_n, cam)
    return RasterOut(color=color, opacity=opac, depth=depth, feature=feature,
                     pseudo_normal=pseudo, surface_xyz=surface,
                     weights=weights[:, None], radii=prep.radius,
                     n_contrib=n_contrib, num_rendered=binning.num_rendered)


def view_depths(p, cam: CameraParams) -> torch.Tensor:
    xyz1 = torch.cat([p["xyz"], torch.ones_like(p["xyz"][:, :1])], dim=-1)
    return (xyz1 @ cam.world_view)[:, 2:3]


def render_view(p, cam: CameraParams, cfg: RasterConfig,
                bg_color: torch.Tensor,
                mean2d_offset: torch.Tensor | None = None) -> dict[str, Any]:
    """The stage-1 render (features [normal, depth²], A = 9)."""
    feats = torch.cat([act_normal(p), view_depths(p, cam) ** 2], dim=-1)
    out = rasterize(p["xyz"], act_scaling(p), act_rotation(p), act_opacity(p),
                    act_shs(p), feats, cam, cfg, bg_color, mean2d_offset)
    mask = (out.n_contrib > 0)[None].to(out.feature.dtype)
    feat = out.feature / torch.clamp(out.opacity, min=1e-5) * mask
    r_depth = out.depth / torch.clamp(out.opacity, min=1e-5) * mask
    return {"render": out.color, "opacity": out.opacity, "depth": r_depth,
            "depth_var": feat[3:4] - r_depth ** 2, "normal": feat[:3],
            "pseudo_normal": out.pseudo_normal, "radii": out.radii,
            "weights": out.weights, "num_rendered": out.num_rendered}


def stage1_loss(gt: torch.Tensor, mask: torch.Tensor, results, opt,
                iteration: int) -> torch.Tensor:
    """The stage-1 loss with the terms `opt` (a dict of the config's
    lambdas) turns on: l1, SSIM, mask entropy, normal-vs-depth, normal
    smoothness and depth variance; terms the config leaves at 0 are refused
    rather than silently dropped."""
    for k in ("lambda_depth_smooth", "lambda_point_entropy",
              "lambda_orientation", "lambda_surface", "lambda_scaling"):
        if opt.get(k, 0.0) > 0:
            raise NotImplementedError(f"reference: {k} > 0")
    rendered = results["render"]
    ll1 = losses.l1_loss(rendered, gt)
    loss = ((1.0 - opt["lambda_dssim"]) * ll1
            + opt["lambda_dssim"] * (1.0 - losses.ssim(rendered, gt)))
    if opt["lambda_mask_entropy"] > 0:
        loss = loss + opt["lambda_mask_entropy"] * losses.mask_entropy_loss(
            results["opacity"], mask)
    if opt["lambda_normal_render_depth"] > 0:
        loss = loss + opt["lambda_normal_render_depth"] * losses.mse_loss(
            results["normal"] * mask, results["pseudo_normal"].detach() * mask)
    if opt["lambda_normal_smooth"] > 0:
        loss = loss + opt["lambda_normal_smooth"] * (
            losses.first_order_edge_aware_loss(results["normal"], gt))
    if opt["lambda_depth_var"] > 0:
        lv = torch.sqrt(torch.clamp(results["depth_var"], min=1e-6)).mean()
        ramp = min(10.0 ** (iteration / float(opt["depth_var_ramp_iters"])),
                   100.0)
        loss = loss + opt["lambda_depth_var"] * ramp * lv
    return loss


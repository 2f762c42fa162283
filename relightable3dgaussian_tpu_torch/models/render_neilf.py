"""Stage-2 ("neilf") render and loss (port of relightable3dgaussian_tpu/models/render_neilf.py).

Every gaussian is shaded with the rendering equation from its cached
incident samples (Fibonacci directions around its normal and their traced
visibility, `update_visibility`), the shaded colour and BRDF maps are
splatted as features in one rasterize call, then normalised by opacity and
sRGB-encoded. In training the shading is `rendering_equation_train`: kernel
K4 on the card, its plain version on the CPU; the splat is K1 and K2 on the
card. The eval path shades with `rendering_equation_eval`: kernel K6 in one
launch on the card, on the CPU its plain version, `ops/shading.py::
rendering_equation` chunked over points; or split over a group of ranks,
each running the same on its share (`sharded_shading`; the visibility
trace likewise, `sharded_trace`). Normals enter the shading
detached, as in the JAX package. The JAX package's seeded-weights path
(`w_seed`) is a TPU scatter workaround and is not ported: the weights come
from the forward.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import losses
from ..ops.camera import pixel_directions
from ..ops.config import RasterConfig
from ..ops.rasterize import rasterize
from ..ops.ray_trace import build_bvh, trace_visibility
from ..ops.shading_cuda import rendering_equation_train
from ..ops.shading_eval_cuda import rendering_equation_eval
from ..train.config import OptimizationConfig
from ..utils import trace
from ..utils.graphics import fibonacci_sphere_sampling, rgb_to_srgb
from ..utils.image import psnr
from .gaussians import GaussianModel
from .lights import light_image, query_light
from .render import ViewInputs

# Feature channels after the 3 colour channels (first-order depth rides the
# rasterizer's own depth channel): train at most depth² 1, pbr 3, normal 3,
# base_color 3, roughness 1, diffuse 3, visibility 1; eval adds specular,
# lights, local and global lights, 3 each.
TRAIN_FEATURE_DIM = 15
EVAL_FEATURE_DIM = 27
# Samples per shading dispatch on the eval path's CPU version: a bound on its
# [P, S, 3] intermediates (the reference chunks inference shading too,
# neilf.py:96-108). K6, on the card, keeps no per-sample value and shades
# every point in one launch.
SHADE_CHUNK_SAMPLES = 4_000_000


def train_feature_channels(opt: OptimizationConfig | None = None
                           ) -> tuple[tuple[str, int], ...]:
    """The splatted feature channels the train losses of `opt` read (every
    channel but the visibility when `opt` is None)."""
    if opt is None:
        return (("depth2", 1), ("pbr", 3), ("normal", 3),
                ("base_color", 3), ("roughness", 1), ("diffuse", 3),
                ("vis", 1))
    ch = []
    if opt.lambda_depth_var > 0:
        ch.append(("depth2", 1))
    ch.append(("pbr", 3))
    if (opt.lambda_normal_render_depth > 0 or opt.lambda_normal_smooth > 0
            or opt.lambda_normal_mvs_depth > 0
            or opt.lambda_light_smooth > 0):
        ch.append(("normal", 3))    # light_smooth compares diffuse and normal
    if opt.lambda_base_color_smooth > 0:
        ch.append(("base_color", 3))
    if opt.lambda_roughness_smooth > 0:
        ch.append(("roughness", 1))
    if opt.lambda_light_smooth > 0:
        ch.append(("diffuse", 3))
    return tuple(ch)


def train_feature_dim(opt: OptimizationConfig | None = None) -> int:
    return sum(w for _, w in train_feature_channels(opt))


class VisibilityCache(NamedTuple):
    """Per-point incident samples and their traced visibility."""
    visibility: torch.Tensor       # [P, S, 1]
    incident_dirs: torch.Tensor    # [P, S, 3]
    incident_areas: torch.Tensor   # [P, S, 1]


@torch.no_grad()
def visibility_rays(model: GaussianModel, incident_dirs: torch.Tensor):
    """The BVH of `model` and the rays `update_visibility` traces for the
    directions [P, S, 3]: from each point's centre, laid out by point in
    the BVH's Morton order. Returns (bvh, rays_o [P·S, 3], rays_d)."""
    bvh = build_bvh(model.xyz, model.get_scaling, model.get_rotation,
                    model.get_opacity[:, 0], model.get_normal)
    P, S = incident_dirs.shape[:2]
    rays_o = model.xyz[bvh.order][:, None].expand(P, S, 3).reshape(-1, 3)
    return bvh, rays_o, incident_dirs[bvh.order].reshape(-1, 3)


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """x with its last row repeated up to a multiple of `multiple` rows."""
    pad = (-x.shape[0]) % multiple
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x


@torch.no_grad()
def update_visibility(model: GaussianModel, sample_num: int,
                      sharded_trace=None) -> VisibilityCache:
    """Trace visibility at `sample_num` Fibonacci directions around each
    point's normal (gaussian_model.py:312-342, deterministic sampling); on
    the card in one K3 launch, or with `sharded_trace`
    (`parallel.point_sharded.make_sharded_trace`) split over its ranks, the
    rays padded to a multiple of their number."""
    dirs, areas = fibonacci_sphere_sampling(model.get_normal, sample_num)
    bvh, rays_o, rays_d = visibility_rays(model, dirs)
    P, S = dirs.shape[:2]
    vis = torch.empty((P, S, 1), dtype=torch.float32, device=dirs.device)
    if sharded_trace is not None:
        n = sharded_trace.group.size
        traced = sharded_trace(bvh, _pad_rows(rays_o, n),
                               _pad_rows(rays_d, n))[:P * S]
    else:
        traced = trace_visibility(bvh, rays_o, rays_d)
    vis[bvh.order] = traced.reshape(P, S, 1)
    return VisibilityCache(visibility=vis, incident_dirs=dirs,
                           incident_areas=areas)


def _shade_points(base_color, roughness, normal, viewdirs, incidents, env,
                  vis: VisibilityCache, sharded_shading=None):
    """The eval shading: `rendering_equation_eval` (K6 on the card; on the
    CPU chunks of at most SHADE_CHUNK_SAMPLES samples), every per-sample
    light kept only as its mean over the samples; or with `sharded_shading`
    (`parallel.point_sharded.make_sharded_shading(full_extras=True)`) split
    over its ranks, P padded to a multiple of their number. Returns (pbr,
    extras), each [P, 3] but the visibility's mean [P, 1]."""
    P = vis.visibility.shape[0]
    if sharded_shading is not None:
        n = sharded_shading.group.size
        pbr, extras = sharded_shading(
            *(_pad_rows(x, n) for x in (base_color, roughness, normal,
                                        viewdirs, incidents)), env,
            *(_pad_rows(x, n) for x in vis))
        return pbr[:P], {k: v[:P] for k, v in extras.items()}
    return rendering_equation_eval(base_color, roughness, normal, viewdirs,
                                   incidents, env, *vis,
                                   chunk_samples=SHADE_CHUNK_SAMPLES)


def render_view(model: GaussianModel, view: ViewInputs, cfg: RasterConfig,
                bg_color: torch.Tensor, env, vis: VisibilityCache,
                is_training: bool, mean2d_offset: torch.Tensor | None = None,
                opt: OptimizationConfig | None = None,
                base_color_scale: torch.Tensor | None = None,
                sharded_shading=None) -> dict[str, Any]:
    """Shade, splat and unpack one view; returns the reference results dict
    (eval adds the specular and light maps and the environment
    background). `base_color_scale` [3] multiplies the linear base color
    before the shading (the relighting benchmark's per-scene albedo scale,
    eval_relighting_syn4.py:95-105). `sharded_shading` splits the eval
    shading over its ranks (`_shade_points`); its gather is not
    differentiable, so training refuses it."""
    if is_training and sharded_shading is not None:
        raise ValueError("render_neilf: the sharded shading is an eval "
                         "path (its gather has no gradient)")
    cam = view.cam
    base_color = model.get_base_color
    if base_color_scale is not None:
        base_color = base_color * base_color_scale[None, :]
    roughness = model.get_roughness
    normal = model.get_normal
    viewdirs = cam.campos[None, :] - model.xyz
    viewdirs = viewdirs / torch.clamp(
        torch.linalg.norm(viewdirs, dim=-1, keepdim=True), min=1e-12)
    incidents = model.get_incidents
    if is_training:
        gl = query_light(env, vis.incident_dirs)
        with trace.span("render.shading", device=viewdirs.device):
            pbr, dif, spec = rendering_equation_train(
                base_color, roughness, normal.detach(), viewdirs, incidents,
                gl, vis.visibility, vis.incident_dirs, vis.incident_areas)
        extras = {"diffuse_light": dif, "specular": spec}
    else:
        with trace.span("render.shading", device=viewdirs.device):
            pbr, extras = _shade_points(base_color, roughness,
                                        normal.detach(), viewdirs, incidents,
                                        env, vis, sharded_shading)

    xyz1 = torch.cat([model.xyz, torch.ones_like(model.xyz[:, :1])], dim=-1)
    depths = (xyz1 @ cam.world_view)[:, 2:3]
    chan_src = {
        "depth2": lambda: depths ** 2,
        "pbr": lambda: pbr,
        "normal": lambda: normal,
        "base_color": lambda: base_color,
        "roughness": lambda: roughness,
        "diffuse": lambda: extras["diffuse_light"],
        "vis": lambda: extras["visibility"],     # eval only
    }
    chans = train_feature_channels(opt if is_training else None)
    feats = [chan_src[name]() for name, _ in chans]
    if not is_training:
        feats += [extras["specular"], extras["incident_lights"],
                  extras["local_incident_lights"],
                  extras["global_incident_lights"]]
    features = torch.cat(feats, dim=-1)

    out = rasterize(model.xyz, model.get_scaling, model.get_rotation,
                    model.get_opacity, model.get_shs, features, cam=cam,
                    cfg=cfg, bg_color=bg_color, mean2d_offset=mean2d_offset)

    mask = (out.n_contrib > 0)[None].to(out.feature.dtype)
    feat = out.feature / torch.clamp(out.opacity, min=1e-5) * mask
    r, idx = {}, 0
    for name, w in chans:
        r[name] = feat[idx:idx + w]
        idx += w
    r_depth = out.depth / torch.clamp(out.opacity, min=1e-5) * mask

    results = {
        "render": out.color,
        "depth": r_depth,
        "pseudo_normal": out.pseudo_normal,
        "surface_xyz": out.surface_xyz,
        "opacity": out.opacity,
        "visibility_filter": out.radii > 0,
        "radii": out.radii,
        "num_rendered": out.num_rendered,
        "num_contrib": out.n_contrib,
        "weights": out.weights,
        "diffuse_light": extras["diffuse_light"],
        "env": light_image(env),
    }
    if "depth2" in r:
        results["depth_var"] = r["depth2"] - r_depth ** 2
    for name, key in (("normal", "normal"), ("roughness", "roughness"),
                      ("vis", "visibility")):
        if name in r:
            results[key] = r[name]
    for name in ("base_color", "diffuse"):
        if name in r:
            results[name] = rgb_to_srgb(r[name])
    r_pbr = r["pbr"]
    results["pbr"] = rgb_to_srgb(r_pbr * out.opacity
                                 + (1 - out.opacity) * bg_color[:, None, None])

    if not is_training:
        for name in ("specular", "lights", "local_lights", "global_lights"):
            results[name] = rgb_to_srgb(feat[idx:idx + 3])
            idx += 3
        dirs_px = pixel_directions(cam, cfg.height, cfg.width)   # [H, W, 3]
        env_px = query_light(env, dirs_px).permute(2, 0, 1)
        results["render_env"] = out.color + (1 - out.opacity) * rgb_to_srgb(env_px)
        results["pbr_env"] = rgb_to_srgb(r_pbr * out.opacity
                                         + (1 - out.opacity) * env_px)
        results["env_only"] = rgb_to_srgb(env_px)
    return results


def calculate_loss(view: ViewInputs, model: GaussianModel,
                   results: dict[str, Any], opt: OptimizationConfig, env):
    """Stage-2 loss (neilf.py:212-318): the SH render's and the PBR render's
    photometric losses and the PBR regularizers; returns (loss, tb_dict)."""
    with trace.span("train.loss"):
        tb = {}
        gt = view.image
        rendered = results["render"]
        rendered_pbr = results["pbr"]

        ll1 = losses.l1_loss(rendered, gt)
        # Both SSIMs as one 6-channel pass: channels are independent.
        smap = losses.ssim_map(torch.cat([rendered, rendered_pbr]),
                               torch.cat([gt, gt]))
        ssim_val = smap[:3].mean()
        ssim_pbr = smap[3:].mean()
        tb["l1"] = ll1
        tb["psnr"] = psnr(rendered[None], gt[None]).mean()
        tb["ssim"] = ssim_val
        loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1.0 - ssim_val)

        ll1_pbr = losses.l1_loss(rendered_pbr, gt)
        tb["l1_pbr"] = ll1_pbr
        tb["ssim_pbr"] = ssim_pbr
        tb["psnr_pbr"] = psnr(rendered_pbr[None], gt[None]).mean()
        loss = loss + opt.lambda_pbr * ((1.0 - opt.lambda_dssim) * ll1_pbr
                                        + opt.lambda_dssim * (1.0 - ssim_pbr))

        if opt.lambda_depth > 0:
            sur_mask = torch.logical_xor(view.image_mask > 0.5, view.depth > 0)
            w = (~sur_mask).to(gt.dtype)
            ld = ((results["depth"] - view.depth).abs() * w).sum() / torch.clamp(
                w.sum(), min=1.0)
            tb["loss_depth"] = ld
            loss = loss + opt.lambda_depth * ld

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

        if opt.lambda_normal_mvs_depth > 0:
            depth_mask = (view.depth > 0).to(gt.dtype)
            lnm = losses.mse_loss(results["normal"] * depth_mask,
                                  view.normal * depth_mask)
            tb["loss_normal_mvs_depth"] = lnm
            loss = loss + opt.lambda_normal_mvs_depth * lnm

        if opt.lambda_light > 0:
            dl = results["diffuse_light"]
            ll = (dl - dl.mean(-1, keepdim=True)).abs().sum() / max(
                3 * model.num_points, 1)
            tb["loss_light"] = ll
            loss = loss + opt.lambda_light * ll

        if opt.lambda_base_color_smooth > 0:
            lb = losses.first_order_edge_aware_loss(
                results["base_color"] * view.image_mask, gt)
            tb["loss_base_color_smooth"] = lb
            loss = loss + opt.lambda_base_color_smooth * lb

        if opt.lambda_roughness_smooth > 0:
            lr = losses.first_order_edge_aware_loss(
                results["roughness"] * view.image_mask, gt)
            tb["loss_roughness_smooth"] = lr
            loss = loss + opt.lambda_roughness_smooth * lr

        if opt.lambda_light_smooth > 0:
            lls = losses.first_order_edge_aware_loss(
                results["diffuse"] * view.image_mask, results["normal"])
            tb["loss_light_smooth"] = lls
            loss = loss + opt.lambda_light_smooth * lls

        if opt.lambda_env_smooth > 0:
            les = losses.tv_loss(light_image(env).permute(2, 0, 1))
            tb["loss_env_smooth"] = les
            loss = loss + opt.lambda_env_smooth * les

        if opt.lambda_normal_smooth > 0:
            lns = losses.tv_loss(results["normal"] * view.image_mask)
            tb["loss_normal_smooth"] = lns
            loss = loss + opt.lambda_normal_smooth * lns

        tb["loss"] = loss
        return loss, tb


def render_neilf(view: ViewInputs, model: GaussianModel, cfg: RasterConfig,
                 bg_color: torch.Tensor, env, vis: VisibilityCache,
                 opt: OptimizationConfig | None = None,
                 is_training: bool = False,
                 mean2d_offset: torch.Tensor | None = None,
                 base_color_scale: torch.Tensor | None = None,
                 sharded_shading=None) -> dict[str, Any]:
    """Stage-2 entry point (the reference's `render_neilf`); with
    `is_training` the results also hold "loss" and "tb_dict". With
    `sharded_shading` the eval shading is split over its ranks, each of
    which must render the same view."""
    if is_training and opt is None:
        raise ValueError("render_neilf: is_training needs an OptimizationConfig")
    with trace.span("render.view", unit=True):
        results = render_view(model, view, cfg, bg_color, env, vis,
                              is_training, mean2d_offset, opt,
                              base_color_scale, sharded_shading)
        if is_training:
            results["loss"], results["tb_dict"] = calculate_loss(
                view, model, results, opt, env)
        return results

"""The reference's stage-2 (NeILF) render, loss and train step, and its
eval render for relighting: plain PyTorch in the dtype of its inputs, after
the port's `models/render_neilf.py`, `ops/shading.py` and
`train/stage2.py`. Imports nothing of the port.

Each point is shaded from S Fibonacci directions about its normal
(`fibonacci_sphere_sampling`, worked out here) with the visibility along
them, the shaded colour splatted as features, normalised by opacity and
sRGB-encoded. The visibility values are the program's own trace (K3 over
P x S rays at set-up): tracing all of them again in plain torch would take
minutes, so `visibility_sample` checks a seeded sample of them by itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import losses
from .camera import pixel_directions
from .graphics import fibonacci_sphere_sampling, rgb_to_srgb
from .lights import equirect_query
from .ray_trace import build_bvh, trace_visibility_plain
from .render import (act_normal, act_opacity, act_rotation, act_scaling,
                     act_shs, rasterize, view_depths)
from .shading import rendering_equation
from .train import Adam, add_stats, grads_or_zeros, learning_rates

SHADE_CHUNK_SAMPLES = 4_000_000   # the eval shading's chunk, as the port's


def act_base_color(p) -> torch.Tensor:
    return torch.sigmoid(p["base_color"]) * 0.77 + 0.03


def act_roughness(p) -> torch.Tensor:
    return torch.sigmoid(p["roughness"]) * 0.9 + 0.09


def act_incidents(p) -> torch.Tensor:
    return torch.cat([p["incidents_dc"], p["incidents_rest"]], dim=1)


def samples(p, S: int):
    """(directions [P, S, 3], areas [P, S, 1]) about each point's normal."""
    with torch.no_grad():
        return fibonacci_sphere_sampling(act_normal(p), S)


def _viewdirs(p, cam) -> torch.Tensor:
    v = cam.campos[None, :] - p["xyz"]
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def train_channels(opt: dict) -> list[str]:
    """The splatted channels the stage-2 train losses read: pbr, with
    depth² where the depth variance is weighted. The other channels'
    losses are refused in `stage2_loss`."""
    return (["depth2"] if opt["lambda_depth_var"] > 0 else []) + ["pbr"]


def train_render(p, cam, cfg, bg, vis, dirs, areas, opt: dict,
                 mean2d_offset=None) -> dict:
    """The stage-2 train render: the shading with a precomputed light (the
    plain function K4 computes), the splat, the sRGB PBR image."""
    env = F.softplus(p["env"])
    gl = equirect_query(env, dirs)
    normal = act_normal(p)
    pbr, ex = rendering_equation(
        act_base_color(p), act_roughness(p), normal.detach(), _viewdirs(p, cam),
        act_incidents(p), lambda d: gl, vis, dirs, areas)
    chans = train_channels(opt)
    src = {"depth2": lambda: view_depths(p, cam) ** 2, "pbr": lambda: pbr}
    feats = torch.cat([src[c]() for c in chans], dim=-1)
    out = rasterize(p["xyz"], act_scaling(p), act_rotation(p), act_opacity(p),
                    act_shs(p), feats, cam, cfg, bg, mean2d_offset)
    mask = (out.n_contrib > 0)[None].to(out.feature.dtype)
    feat = out.feature / torch.clamp(out.opacity, min=1e-5) * mask
    r_pbr = feat[chans.index("pbr"):chans.index("pbr") + 3]
    return {"render": out.color, "opacity": out.opacity,
            "pbr": rgb_to_srgb(r_pbr * out.opacity
                               + (1 - out.opacity) * bg[:, None, None]),
            "diffuse_light": ex["diffuse_light"], "env": env,
            "weights": out.weights, "radii": out.radii}


def stage2_loss(gt, results, opt: dict, n_points: int) -> torch.Tensor:
    """The stage-2 loss: the SH render's and the PBR render's l1 and SSIM,
    the diffuse light's spread and the env map's total variation, with the
    configuration's weights; other terms are refused, not dropped."""
    for k in ("lambda_depth", "lambda_mask_entropy", "lambda_depth_var",
              "lambda_normal_render_depth", "lambda_normal_mvs_depth",
              "lambda_base_color_smooth", "lambda_roughness_smooth",
              "lambda_light_smooth", "lambda_normal_smooth"):
        if opt.get(k, 0.0) > 0:
            raise NotImplementedError(f"reference: {k} > 0 in stage 2")
    d = opt["lambda_dssim"]
    smap = losses.ssim_map(torch.cat([results["render"], results["pbr"]]),
                           torch.cat([gt, gt]))
    loss = ((1 - d) * losses.l1_loss(results["render"], gt)
            + d * (1 - smap[:3].mean()))
    loss = loss + opt["lambda_pbr"] * (
        (1 - d) * losses.l1_loss(results["pbr"], gt) + d * (1 - smap[3:].mean()))
    if opt["lambda_light"] > 0:
        dl = results["diffuse_light"]
        loss = loss + opt["lambda_light"] * (
            (dl - dl.mean(-1, keepdim=True)).abs().sum() / max(3 * n_points, 1))
    if opt["lambda_env_smooth"] > 0:
        loss = loss + opt["lambda_env_smooth"] * losses.tv_loss(
            results["env"].permute(2, 0, 1))
    return loss


def stage2_step(params: dict, adam: Adam, stats: dict, view, iteration: int,
                vis, dirs, areas, *, cfg, opt: dict, spatial_lr_scale: float,
                bg: torch.Tensor):
    """One stage-2 step in place (the env map is the leaf "env"); returns
    (loss, the gradients Adam got)."""
    m2d = torch.zeros((params["xyz"].shape[0], 2), dtype=bg.dtype,
                      device=bg.device, requires_grad=True)
    results = train_render(params, view.cam, cfg, bg, vis, dirs, areas, opt,
                           m2d)
    loss = stage2_loss(view.image, results, opt, params["xyz"].shape[0])
    *g, g_m2d = grads_or_zeros(loss, params, (m2d,))
    grads = dict(zip(params, g))
    adam.step(grads, learning_rates(opt, iteration, spatial_lr_scale))
    add_stats(stats, g_m2d, grads["normal"], results["weights"][:, 0].detach(),
              results["radii"], (cfg.width, cfg.height))
    return loss.detach(), grads


def _shade_eval(p, cam, light, vis, dirs, areas):
    """The eval shading in chunks of SHADE_CHUNK_SAMPLES samples: (pbr,
    extras), the per-sample lights kept as their means over the samples."""
    P, S = vis.shape[:2]
    chunk = max(1, SHADE_CHUNK_SAMPLES // S)
    bc, rough, n, v = (act_base_color(p), act_roughness(p), act_normal(p),
                       _viewdirs(p, cam))
    inc = act_incidents(p)
    parts = []
    for i in range(0, P, chunk):
        sl = slice(i, i + chunk)
        pbr, ex = rendering_equation(bc[sl], rough[sl], n[sl], v[sl], inc[sl],
                                     light, vis[sl], dirs[sl], areas[sl])
        parts.append((pbr, {k: (x if x.dim() == 2 else x.mean(-2))
                            for k, x in ex.items()}))
    return (torch.cat([q for q, _ in parts]),
            {k: torch.cat([ex[k] for _, ex in parts]) for k in parts[0][1]})


@torch.no_grad()
def render_eval(p, cam, cfg, bg, envmap, transform, vis, dirs, areas) -> dict:
    """The relighting frame (`render_neilf(is_training=False)` under a fixed
    HDR map with a direction transform): pbr_env, depth and normal maps."""
    light = lambda d: equirect_query(envmap, d, transform)
    pbr, ex = _shade_eval(p, cam, light, vis, dirs, areas)
    normal = act_normal(p)
    feats = torch.cat([view_depths(p, cam) ** 2, pbr, normal, act_base_color(p),
                       act_roughness(p), ex["diffuse_light"], vis.mean(-2),
                       ex["specular"], ex["incident_lights"],
                       ex["local_incident_lights"],
                       ex["global_incident_lights"]], dim=-1)
    out = rasterize(p["xyz"], act_scaling(p), act_rotation(p), act_opacity(p),
                    act_shs(p), feats, cam, cfg, bg)
    mask = (out.n_contrib > 0)[None].to(out.feature.dtype)
    feat = out.feature / torch.clamp(out.opacity, min=1e-5) * mask
    env_px = equirect_query(envmap, pixel_directions(cam, cfg.height,
                                                     cfg.width),
                            transform).permute(2, 0, 1)
    return {"pbr_env": rgb_to_srgb(feat[1:4] * out.opacity
                                   + (1 - out.opacity) * env_px),
            "depth": out.depth / torch.clamp(out.opacity, min=1e-5) * mask,
            "normal": feat[4:7]}


@torch.no_grad()
def visibility_sample(p, dirs, rows: torch.Tensor,
                      cols: torch.Tensor) -> torch.Tensor:
    """[n] visibility of the rays from points `rows` along their sample
    directions `cols` (T where T ≥ T_MIN, else 0), traced by the plain rule
    over the reference's own clusters."""
    bvh = build_bvh(p["xyz"], act_scaling(p), act_rotation(p),
                    act_opacity(p)[:, 0], act_normal(p))
    return trace_visibility_plain(bvh, p["xyz"][rows], dirs[rows, cols])[:, 0]


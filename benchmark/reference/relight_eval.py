"""The reference's Synthetic4Relight evaluation of one test view (the
reference's eval_relighting_syn4.py): the stage-2 eval render under a
fixed HDR map, the base colour times the scene's albedo scale before the
shading, its images over the ground truth's mask, and their seven scores
(PSNR, SSIM and LPIPS of the PBR render and of the albedo, the roughness
MSE). Plain PyTorch in the dtype of its inputs, built from `neilf.py`,
`shading.py` and `render.py`; the shading runs over blocks of points, so
that P x S samples in float64 fit at S = 384. Imports nothing of the port.
"""
from __future__ import annotations

import torch

from . import losses
from .camera import pixel_directions
from .graphics import rgb_to_srgb
from .lights import equirect_query
from .lpips import lpips
from .neilf import _viewdirs, act_base_color, act_incidents, act_roughness
from .render import (act_normal, act_opacity, act_rotation, act_scaling,
                     act_shs, rasterize)
from .shading import rendering_equation

BLOCK_SAMPLES = 4_000_000      # samples a block of the shading
SCORES = ("psnr_pbr", "ssim_pbr", "lpips_pbr", "psnr_albedo", "ssim_albedo",
          "lpips_albedo", "mse_roughness")


def shade(p, cam, envmap, vis, dirs, areas, scale) -> torch.Tensor:
    """[P, 3] linear PBR colour of every point under `envmap`, its base
    colour times `scale` [3]."""
    P, S = vis.shape[:2]
    block = max(1, BLOCK_SAMPLES // S)
    base = act_base_color(p) * scale
    rough, normal, view = act_roughness(p), act_normal(p), _viewdirs(p, cam)
    inc = act_incidents(p)
    light = lambda d: equirect_query(envmap, d)  # noqa: E731
    return torch.cat([
        rendering_equation(base[i:i + block], rough[i:i + block],
                           normal[i:i + block], view[i:i + block],
                           inc[i:i + block], light, vis[i:i + block],
                           dirs[i:i + block], areas[i:i + block])[0]
        for i in range(0, P, block)])


@torch.no_grad()
def render(p, cam, cfg, background: float, envmap, vis, dirs, areas,
           scale) -> dict:
    """The eval render's maps the evaluation reads: pbr (over the
    background colour), pbr_env (over the map), base_color (sRGB, scaled),
    roughness and env_only (the map seen from each pixel, sRGB)."""
    pbr = shade(p, cam, envmap, vis, dirs, areas, scale)
    feats = torch.cat([pbr, act_base_color(p) * scale, act_roughness(p)], -1)
    bg = torch.full((3,), background, dtype=pbr.dtype, device=pbr.device)
    out = rasterize(p["xyz"], act_scaling(p), act_rotation(p), act_opacity(p),
                    act_shs(p), feats, cam, cfg, bg)
    covered = (out.n_contrib > 0)[None].to(pbr.dtype)
    feat = out.feature / torch.clamp(out.opacity, min=1e-5) * covered
    dirs_px = pixel_directions(cam, cfg.height, cfg.width)
    env_px = equirect_query(envmap, dirs_px).permute(2, 0, 1)
    o = out.opacity
    return {"pbr": rgb_to_srgb(feat[:3] * o + (1 - o) * bg[:, None, None]),
            "pbr_env": rgb_to_srgb(feat[:3] * o + (1 - o) * env_px),
            "base_color": rgb_to_srgb(feat[3:6]), "roughness": feat[6:7],
            "env_only": rgb_to_srgb(env_px)}


def images(res: dict, gt: dict, background: float) -> dict:
    """The evaluation's images over the mask: the render's pbr,
    base_color and roughness and the ground truths ({image, mask, albedo,
    roughness}) with `background` outside, pbr_env with the map there."""
    m = gt["mask"]
    over = lambda x: x * m + (1 - m) * background  # noqa: E731
    return {"pbr": over(res["pbr"]),
            "pbr_env": res["pbr"] * m + (1 - m) * res["env_only"],
            "base_color": over(res["base_color"]),
            "roughness": over(res["roughness"]),
            "gt": over(gt["image"]), "gt_albedo": over(gt["albedo"]),
            "gt_roughness": over(gt["roughness"])}


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PSNR in dB of two images in [0, 1] (the MSE floored at 1e-12)."""
    mse = torch.clamp((a - b).square().mean(), min=1e-12)
    return 20 * torch.log10(1.0 / torch.sqrt(mse))


@torch.no_grad()
def scores(img: dict, lpips_weights: dict) -> dict:
    """The seven scores (SCORES) of a view's images, as floats; LPIPS in
    the dtype of its weights."""
    dt = lpips_weights["features.0.weight"].dtype
    d = lpips(torch.stack([img["pbr"], img["base_color"]]).to(dt),
              torch.stack([img["gt"], img["gt_albedo"]]).to(dt), lpips_weights)
    rough = img["roughness"].expand(3, -1, -1)
    values = (psnr(img["pbr"], img["gt"]),
              losses.ssim(img["pbr"], img["gt"]), d[0],
              psnr(img["base_color"], img["gt_albedo"]),
              losses.ssim(img["base_color"], img["gt_albedo"]), d[1],
              (rough - img["gt_roughness"]).square().mean())
    return {k: float(v) for k, v in zip(SCORES, values)}


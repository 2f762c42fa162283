"""Environment lights (port of relightable3dgaussian_tpu/models/lights.py).

`DirectLightMap` is the learnable equirect map of stage 2: a raw [H, 2H, 3]
`nn.Parameter` behind a softplus. `EnvLight` is a fixed HDR map with an
optional 3×3 direction transform. Both are queried by `equirect_query`,
whose bilinear lookup is `F.grid_sample` with align_corners=True and zero
padding, which the JAX package replicates. Its one-hot-matmul branch for
small maps is a TPU workaround and is not carried over. Loading an HDR file
comes with the relighting entry points.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn


def grid_sample_bilinear(img: torch.Tensor, gx: torch.Tensor,
                         gy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img [H, W, C] at normalized coordinates gx, gy
    (same shape, in [-1, 1]) → [..., C]."""
    grid = torch.stack([gx, gy], dim=-1).reshape(1, 1, -1, 2)
    out = F.grid_sample(img.permute(2, 0, 1)[None], grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[0, :, 0].T.reshape(*gx.shape, img.shape[-1])


def equirect_query(envmap: torch.Tensor, dirs: torch.Tensor,
                   transform: torch.Tensor | None = None) -> torch.Tensor:
    """Radiance of the equirect map [H, W, 3] for unit directions [..., 3]:
    φ = arccos(clip z) − 1e-6 down the rows, θ = atan2(y, x) across the
    columns (gy = 2φ/π − 1, gx = −θ/π)."""
    shape = dirs.shape
    d = dirs.reshape(-1, 3)
    if transform is not None:
        d = d @ transform.T
    phi = torch.arccos(torch.clamp(d[:, 2], -1.0, 1.0)) - 1e-6
    theta = torch.atan2(d[:, 1], d[:, 0])
    gy = (phi / math.pi) * 2.0 - 1.0
    gx = -theta / math.pi
    return grid_sample_bilinear(envmap, gx, gy).reshape(shape)


def bilinear_resize_2x(img: torch.Tensor) -> torch.Tensor:
    """[H, W, C] → [2H, 2W, C], bilinear with align_corners."""
    H, W = img.shape[:2]
    gy, gx = torch.meshgrid(torch.linspace(-1, 1, 2 * H, device=img.device),
                            torch.linspace(-1, 1, 2 * W, device=img.device),
                            indexing="ij")
    return grid_sample_bilinear(img, gx, gy)


class DirectLightMap(nn.Module):
    """Learnable environment light: raw map `env` [H, 2H, 3], radiance
    softplus(env), initialised to light_init · U[0, 1) from `generator`
    on `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, H: int = 16, light_init: float = 0.5,
                 generator: torch.Generator | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.env = nn.Parameter(light_init * torch.rand(
            (H, 2 * H, 3), generator=generator, device=device))

    @classmethod
    def from_raw(cls, env: torch.Tensor) -> "DirectLightMap":
        light = cls.__new__(cls)
        nn.Module.__init__(light)
        light.env = nn.Parameter(env.detach().clone())
        return light

    def get_env(self) -> torch.Tensor:
        return F.softplus(self.env)

    def direct_light(self, dirs: torch.Tensor) -> torch.Tensor:
        return equirect_query(self.get_env(), dirs)


def upsample(light: DirectLightMap) -> DirectLightMap:
    """The map at twice the resolution (direct_light_map.py:85-101); the
    caller upsamples Adam's moments with `bilinear_resize_2x` too."""
    with torch.no_grad():
        return DirectLightMap.from_raw(bilinear_resize_2x(light.env))


class EnvLight(NamedTuple):
    """Fixed HDR environment (scene/envmap.py)."""
    envmap: torch.Tensor                    # [H, W, 3] linear HDR
    transform: torch.Tensor | None = None   # optional [3, 3]

    def direct_light(self, dirs: torch.Tensor) -> torch.Tensor:
        return equirect_query(self.envmap, dirs, self.transform)


def query_light(light, dirs: torch.Tensor) -> torch.Tensor:
    """Radiance of either light model for directions [..., 3]."""
    if isinstance(light, (DirectLightMap, EnvLight)):
        return light.direct_light(dirs)
    raise TypeError(f"unknown light type {type(light)}")


def light_image(light) -> torch.Tensor:
    """The environment image (activated) for logging and TV regularization."""
    if isinstance(light, DirectLightMap):
        return light.get_env()
    if isinstance(light, EnvLight):
        return light.envmap
    raise TypeError(f"unknown light type {type(light)}")

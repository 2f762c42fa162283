"""Environment lights (port of relightable3dgaussian_tpu/models/lights.py).

`DirectLightMap` is the learnable equirect map of stage 2: a raw [H, 2H, 3]
`nn.Parameter` behind a softplus. `EnvLight` is a fixed HDR map with an
optional 3×3 direction transform. Both answer `get_env()` (the activated
map) and `transform` (None for the learnable map). Both are queried by
`equirect_query` (`ops/env_lookup_cuda.py`): on CPU tensors its plain
version `equirect_query_plain`, whose bilinear lookup is `F.grid_sample`
with align_corners=True and zero padding, which the JAX package replicates
(its one-hot-matmul branch for small maps is a TPU workaround and is not
carried over); on CUDA tensors the hand-written pair of
`csrc/env_lookup.cu`, the same formula, whose backward gives the map its
gradient (bitwise the same from run to run up to 2048 texels).
`load_env_light` reads a relighting map: EXR (ZIP, RLE or none) and
Radiance HDR as linear, any other file as an 8-bit sRGB PNG, by the port's
own readers.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.env_lookup_cuda import (equirect_query,  # noqa: F401
                                   equirect_query_plain, grid_sample_bilinear)
from ..utils.graphics import srgb_to_rgb


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
    transform = None       # the map's directions are the world's

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

    def get_env(self) -> torch.Tensor:
        return self.envmap

    def direct_light(self, dirs: torch.Tensor) -> torch.Tensor:
        return equirect_query(self.envmap, dirs, self.transform)


def load_env_light(path: str, scale: float = 1.0,
                   device: torch.device | str = "cuda") -> EnvLight:
    """The linear HDR map of `path` times `scale` as an `EnvLight` on
    `device` (the card unless the caller asks for the CPU)."""
    img = _load_image_linear(path)
    return EnvLight(envmap=torch.as_tensor(img * scale, dtype=torch.float32,
                                           device=device))


def _load_image_linear(path: str) -> np.ndarray:
    """[H, W, 3] float32 linear radiance: .exr and .hdr as stored, any other
    file as an 8-bit PNG / 255 through the sRGB decode."""
    from ..scene import exr, image_io  # the scene package imports this one
    if path.endswith(".exr"):
        arr = exr.read_exr_rgb(path)
    elif path.endswith(".hdr"):
        arr = exr.read_hdr(path)
    else:
        arr = image_io.read_png(path)[:, :, :3].astype(np.float32) / 255.0
        arr = srgb_to_rgb(torch.from_numpy(arr)).numpy()
    return arr[:, :, :3].astype(np.float32)


def query_light(light, dirs: torch.Tensor, plain: bool = False
                ) -> torch.Tensor:
    """Radiance of either light model for directions [..., 3]; `plain`
    takes `equirect_query_plain` on any device (a yardstick's lookup)."""
    if not isinstance(light, (DirectLightMap, EnvLight)):
        raise TypeError(f"unknown light type {type(light)}")
    if plain:
        return equirect_query_plain(light.get_env(), dirs, light.transform)
    return light.direct_light(dirs)


def light_image(light) -> torch.Tensor:
    """The environment image (activated) for logging and TV regularization."""
    if isinstance(light, (DirectLightMap, EnvLight)):
        return light.get_env()
    raise TypeError(f"unknown light type {type(light)}")

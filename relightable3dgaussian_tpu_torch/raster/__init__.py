"""Drop-in rasterizer facade with the reference wrapper's API (port of
relightable3dgaussian_tpu/raster/__init__.py).

The reference exposes `GaussianRasterizationSettings` and
`GaussianRasterizer` (gaussian_renderer/r3dg_rasterization.py:188-262),
which return a 10-tuple. This facade maps that surface onto
`ops.rasterize.rasterize`, so reference-style call sites port mechanically;
new code calls `rasterize` directly. The feature width comes from the
`features` given. `GaussianRasterizer`'s keyword overrides set fields of the
port's `RasterConfig`; the JAX package's TPU budget fields
(`ops.config.TPU_BUDGET_FIELDS`) are accepted with no effect, and any other
key raises.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.camera import CameraParams
from ..ops.config import TPU_BUDGET_FIELDS, RasterConfig
from ..ops.rasterize import rasterize

_SETTINGS_FIELDS = ("height", "width", "sh_degree", "scale_modifier",
                    "compute_pseudo_normal")


class GaussianRasterizationSettings(NamedTuple):
    image_height: int
    image_width: int
    tanfovx: float
    tanfovy: float
    cx: float
    cy: float
    bg: torch.Tensor
    scale_modifier: float
    viewmatrix: torch.Tensor      # [4, 4] transposed world→camera
    projmatrix: torch.Tensor      # [4, 4] transposed world→clip
    sh_degree: int
    campos: torch.Tensor
    prefiltered: bool = False
    backward_geometry: bool = True
    computer_pseudo_normal: bool = True
    debug: bool = False


def _camera_from_settings(s: GaussianRasterizationSettings) -> CameraParams:
    device = torch.as_tensor(s.viewmatrix).device
    fx = s.image_width / (2.0 * s.tanfovx)
    fy = s.image_height / (2.0 * s.tanfovy)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return CameraParams(
        world_view=t(s.viewmatrix), full_proj=t(s.projmatrix),
        campos=t(s.campos), focal=t([fx, fy]), center=t([s.cx, s.cy]),
        tan_fov=t([s.tanfovx, s.tanfovy]))


def _view_z_positive(positions: torch.Tensor,
                     viewmatrix: torch.Tensor) -> torch.Tensor:
    """[P] bool: view-space z > 0.2 (the reference's `mark_visible`,
    rasterize_points.cu:237-256)."""
    ones = torch.ones_like(positions[:, :1])
    p_view = torch.cat([positions, ones], -1) @ viewmatrix.to(positions)
    return p_view[:, 2] > 0.2


class GaussianRasterizer:
    def __init__(self, raster_settings: GaussianRasterizationSettings,
                 **config_overrides):
        fields = {f.name for f in dataclasses.fields(RasterConfig)}
        unknown = sorted(k for k in config_overrides
                         if k not in fields and k not in TPU_BUDGET_FIELDS
                         or k in _SETTINGS_FIELDS)
        if unknown:
            raise TypeError(f"GaussianRasterizer: unknown or settings-owned "
                            f"config overrides {unknown}")
        self.raster_settings = raster_settings
        self.cam = _camera_from_settings(raster_settings)
        self._overrides = {k: v for k, v in config_overrides.items()
                           if k in fields}

    def _config(self) -> RasterConfig:
        s = self.raster_settings
        return RasterConfig(
            height=s.image_height, width=s.image_width,
            sh_degree=s.sh_degree, scale_modifier=s.scale_modifier,
            compute_pseudo_normal=s.computer_pseudo_normal, **self._overrides)

    def markVisible(self, positions: torch.Tensor) -> torch.Tensor:
        """[P] bool frustum visibility: view z > 0.2."""
        return _view_z_positive(positions, self.cam.world_view)

    def __call__(self, means3D, means2D=None, opacities=None, shs=None,
                 colors_precomp=None, scales=None, rotations=None,
                 cov3D_precomp=None, features=None):
        """Returns the reference 10-tuple: (num_rendered, num_contrib,
        color, opacity, depth, feature, pseudo_normal, surface_xyz,
        weights, radii). `means2D` is not read: gradients reach means3D
        directly. `cov3D_precomp` is packed [P, 6] (the reference's) or
        full [P, 3, 3] (the JAX package's)."""
        if features is None:
            raise ValueError("GaussianRasterizer: features [P, S] are "
                             "required")
        out = rasterize(
            means3D, scales, rotations, opacities, shs, features,
            cam=self.cam, cfg=self._config(),
            bg_color=torch.as_tensor(self.raster_settings.bg,
                                     dtype=torch.float32,
                                     device=means3D.device),
            colors_precomp=colors_precomp, cov3d_precomp=cov3D_precomp)
        return (out.num_rendered, out.n_contrib, out.color, out.opacity,
                out.depth, out.feature, out.pseudo_normal, out.surface_xyz,
                out.weights, out.radii)


def mark_visible(positions: torch.Tensor, viewmatrix: torch.Tensor,
                 projmatrix: torch.Tensor) -> torch.Tensor:
    """Functional frustum check (the reference's `_C.mark_visible`); like
    the reference it tests only view-space z, so `projmatrix` is unused."""
    del projmatrix
    return _view_z_positive(positions, torch.as_tensor(viewmatrix))

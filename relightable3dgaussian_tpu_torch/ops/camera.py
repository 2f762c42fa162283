"""Camera parameters for the rasterizer (port of relightable3dgaussian_tpu/ops/camera.py).

`CameraParams` holds small float tensors on one device; image height/width
live in `RasterConfig`. `world_view` and `full_proj` are stored TRANSPOSED,
as in the JAX package, so points transform as row vectors:
`p_view = [x y z 1] @ world_view`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import graphics


class CameraParams(NamedTuple):
    world_view: torch.Tensor   # [4, 4] transposed world→camera
    full_proj: torch.Tensor    # [4, 4] transposed world→clip (= wv @ proj)
    campos: torch.Tensor       # [3] camera center in world space
    focal: torch.Tensor        # [2] (fx, fy) in pixels
    center: torch.Tensor       # [2] (cx, cy) principal point in pixels
    tan_fov: torch.Tensor      # [2] (tan(fovx/2), tan(fovy/2))


def make_camera_params(R: np.ndarray, T: np.ndarray, width: int, height: int,
                       fovx: float | None = None, fovy: float | None = None,
                       fx: float | None = None, fy: float | None = None,
                       cx: float | None = None, cy: float | None = None,
                       znear: float = 0.01, zfar: float = 100.0,
                       trans: np.ndarray | None = None, scale: float = 1.0,
                       device: torch.device | str = "cpu") -> CameraParams:
    """Build CameraParams from COLMAP-style extrinsics + FoV or intrinsics."""
    w2c = graphics.world_to_view(R, T, trans, scale)
    if fx is None:
        assert fovx is not None and fovy is not None
        fx = graphics.fov2focal(fovx, width)
        fy = graphics.fov2focal(fovy, height)
        cx, cy = width / 2, height / 2
        proj = graphics.projection_matrix(znear, zfar, fovx, fovy)
    else:
        assert cx is not None and cy is not None
        proj = graphics.projection_matrix_center_shift(
            znear, zfar, cx, cy, fx, fy, width, height)
        fovx = graphics.focal2fov(fx, width)
        fovy = graphics.focal2fov(fy, height)
    world_view = w2c.T
    full_proj = world_view @ proj.T
    campos = np.linalg.inv(w2c)[:3, 3]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return CameraParams(
        world_view=t(world_view),
        full_proj=t(full_proj),
        campos=t(campos),
        focal=t([fx, fy]),
        center=t([cx, cy]),
        tan_fov=t([np.tan(fovx * 0.5), np.tan(fovy * 0.5)]),
    )

"""Camera parameters for the rasterizer (port of relightable3dgaussian_tpu/ops/camera.py).

`CameraParams` holds small float tensors on one device; image height/width
live in `RasterConfig`. `world_view` and `full_proj` are stored TRANSPOSED,
as in the JAX package, so points transform as row vectors:
`p_view = [x y z 1] @ world_view`. `pixel_directions` gives the per-pixel
world-space ray directions the stage-2 eval samples the environment with.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import graphics, trace


class CameraParams(NamedTuple):
    world_view: torch.Tensor   # [4, 4] transposed world→camera
    full_proj: torch.Tensor    # [4, 4] transposed world→clip (= wv @ proj)
    campos: torch.Tensor       # [3] camera center in world space
    focal: torch.Tensor        # [2] (fx, fy) in pixels
    center: torch.Tensor       # [2] (cx, cy) principal point in pixels
    tan_fov: torch.Tensor      # [2] (tan(fovx/2), tan(fovy/2))

    @property
    def c2w_rot(self) -> torch.Tensor:
        """[3, 3] camera→world rotation (world_view[:3, :3] is R_w2c^T)."""
        return self.world_view[:3, :3]


def make_camera_params(R: np.ndarray, T: np.ndarray, width: int, height: int,
                       fovx: float | None = None, fovy: float | None = None,
                       fx: float | None = None, fy: float | None = None,
                       cx: float | None = None, cy: float | None = None,
                       znear: float = 0.01, zfar: float = 100.0,
                       trans: np.ndarray | None = None, scale: float = 1.0,
                       device: torch.device | str = "cuda") -> CameraParams:
    """Build CameraParams from COLMAP-style extrinsics + FoV or intrinsics, on
    `device` (the card unless the caller asks for the CPU)."""
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
        trace.count("host.syncs")   # a pageable copy waits for the stream
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return CameraParams(
        world_view=t(world_view),
        full_proj=t(full_proj),
        campos=t(campos),
        focal=t([fx, fy]),
        center=t([cx, cy]),
        tan_fov=t([np.tan(fovx * 0.5), np.tan(fovy * 0.5)]),
    )


def pixel_directions(cam: CameraParams, height: int, width: int) -> torch.Tensor:
    """[H, W, 3] per-pixel unit ray directions in world space."""
    dev = cam.focal.device
    u = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    x = (u - cam.center[0]) / cam.focal[0]
    y = (v - cam.center[1]) / cam.focal[1]
    d = torch.stack([x.expand(height, width), y.expand(height, width),
                     torch.ones((height, width), device=dev)], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return torch.einsum("ij,hwj->hwi", cam.c2w_rot, d)

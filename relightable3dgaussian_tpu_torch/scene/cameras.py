"""Host-side Camera: image data + intrinsics → ViewInputs on the card.

Port of relightable3dgaussian_tpu/scene/cameras.py (the reference's
scene/cameras.py and utils/camera_utils.py): resolution scaling (with the
1.6K auto-downscale), depth/normal/mask attachment, the cameras.json round
trip, and `view_inputs`, the renderer's per-view tensors on a device (the
card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from ..models.render import ViewInputs
from ..ops.camera import CameraParams, make_camera_params
from ..utils import graphics
from .image_io import resize_image


@dataclasses.dataclass
class Camera:
    uid: int
    R: np.ndarray                 # [3,3] camera-to-world rotation
    T: np.ndarray                 # [3] world-to-camera translation
    fovx: float | None
    fovy: float | None
    width: int
    height: int
    image_name: str = ""
    image: np.ndarray | None = None       # [H, W, 3] float
    image_mask: np.ndarray | None = None  # [H, W]
    depth: np.ndarray | None = None       # [H, W]
    normal: np.ndarray | None = None      # [H, W, 3]
    fx: float | None = None
    fy: float | None = None
    cx: float | None = None
    cy: float | None = None
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    def camera_params(self, device: torch.device | str = "cuda"
                      ) -> CameraParams:
        return make_camera_params(
            self.R, self.T, self.width, self.height, fovx=self.fovx,
            fovy=self.fovy, fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy,
            znear=self.znear, zfar=self.zfar, trans=self.trans,
            scale=self.scale, device=device)

    def view_inputs(self, device: torch.device | str = "cuda") -> ViewInputs:
        """→ models.render.ViewInputs on `device` (the card unless the caller
        asks for the CPU), with zero-filled missing tensors."""
        h, w = self.height, self.width
        img = (np.moveaxis(np.clip(self.image, 0.0, 1.0), -1, 0)
               if self.image is not None else np.zeros((3, h, w), np.float32))
        mask = (self.image_mask[None] if self.image_mask is not None
                else np.ones((1, h, w), np.float32))
        depth = (self.depth[None] if self.depth is not None
                 else np.zeros((1, h, w), np.float32))
        normal = (np.moveaxis(self.normal, -1, 0)
                  if self.normal is not None
                  else np.zeros((3, h, w), np.float32))
        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                   device=device)

        return ViewInputs(cam=self.camera_params(device), image=t(img),
                          image_mask=t(mask), depth=t(depth),
                          normal=t(normal))

    @property
    def world_view_transform(self) -> np.ndarray:
        """[4, 4] float32 world→camera matrix, transposed (points
        transform as `p_row @ M`)."""
        return graphics.world_to_view(self.R, self.T, self.trans,
                                      self.scale).T

    @property
    def c2w(self) -> np.ndarray:
        """[4, 4] float32 camera→world matrix."""
        return np.linalg.inv(graphics.world_to_view(self.R, self.T,
                                                    self.trans, self.scale))

    @property
    def camera_center(self) -> np.ndarray:
        return self.c2w[:3, 3]

    def intrinsics(self) -> np.ndarray:
        """[3, 3] float32 pinhole matrix: fx, fy, cx, cy where given,
        else focal lengths from the FoV and the image centre."""
        if self.fx is None:
            fx = graphics.fov2focal(self.fovx, self.width)
            fy = graphics.fov2focal(self.fovy, self.height)
            cx, cy = self.width / 2, self.height / 2
        else:
            fx, fy, cx, cy = self.fx, self.fy, self.cx, self.cy
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def resolve_resolution(width: int, height: int, resolution: int,
                       resolution_scale: float = 1.0) -> tuple[int, int]:
    """Mirror loadCam's sizing rules (camera_utils.py:20-40): explicit
    downscale factor when resolution > 0, else auto-cap at 1.6K width."""
    if resolution in (1, 2, 4, 8):
        return (round(width / (resolution_scale * resolution)),
                round(height / (resolution_scale * resolution)))
    if resolution == -1:
        if width > 1600:
            # the default filter shows it once, as the JAX package's WARNED
            warnings.warn("big images detected: auto-rescaling to 1.6K (use "
                          "--resolution 1 to disable)", stacklevel=2)
            global_down = width / 1600
        else:
            global_down = 1
    else:
        global_down = width / resolution
    scale = float(global_down) * resolution_scale
    return round(width / scale), round(height / scale)


def load_camera(info, resolution: int = -1,
                resolution_scale: float = 1.0) -> Camera:
    """Build a Camera from a reader CameraInfo, rescaling image + intrinsics."""
    w, h = resolve_resolution(info.width, info.height, resolution,
                              resolution_scale)
    sx, sy = w / info.width, h / info.height

    image = info.image
    mask = info.image_mask
    depth = info.depth
    normal = info.normal
    if (w, h) != (info.width, info.height):
        if image is not None:
            image = resize_image(image, w, h)
        if mask is not None:
            mask = resize_image(mask, w, h)
        if depth is not None:
            depth = resize_image(depth, w, h)
        if normal is not None:
            normal = resize_image(normal, w, h)

    fx = info.fx * sx if info.fx is not None else None
    fy = info.fy * sy if info.fy is not None else None
    cx = info.cx * sx if info.cx is not None else None
    cy = info.cy * sy if info.cy is not None else None
    return Camera(uid=info.uid, R=info.R, T=info.T, fovx=info.FovX,
                  fovy=info.FovY, width=w, height=h,
                  image_name=info.image_name, image=image, image_mask=mask,
                  depth=depth, normal=normal, fx=fx, fy=fy, cx=cx, cy=cy)


def camera_to_json(idx: int, cam) -> dict:
    """cameras.json entry (camera_utils.py:87-111)."""
    w2c = graphics.world_to_view(cam.R, cam.T)
    c2w = np.linalg.inv(w2c)
    pos = c2w[:3, 3]
    rot = c2w[:3, :3]
    fx = cam.fx if cam.fx is not None else graphics.fov2focal(cam.FovX if
                                                              hasattr(cam, "FovX") else cam.fovx, cam.width)
    fy = cam.fy if cam.fy is not None else graphics.fov2focal(cam.FovY if
                                                              hasattr(cam, "FovY") else cam.fovy, cam.height)
    return {
        "id": idx,
        "img_name": getattr(cam, "image_name", ""),
        "width": cam.width,
        "height": cam.height,
        "position": pos.tolist(),
        "rotation": [r.tolist() for r in rot],
        "fx": float(fx),
        "fy": float(fy),
    }


def camera_from_json(data: dict) -> Camera:
    """Inverse of camera_to_json (JSON_to_camera, camera_utils.py:114-150)."""
    rot = np.array(data["rotation"])
    pos = np.array(data["position"])
    c2w = np.eye(4)
    c2w[:3, :3] = rot
    c2w[:3, 3] = pos
    w2c = np.linalg.inv(c2w)
    R = w2c[:3, :3].T
    T = w2c[:3, 3]
    w, h = data["width"], data["height"]
    fovx = graphics.focal2fov(data["fx"], w)
    fovy = graphics.focal2fov(data["fy"], h)
    return Camera(uid=data.get("id", 0), R=R, T=T, fovx=fovx, fovy=fovy,
                  width=w, height=h, image_name=data.get("img_name", ""))


def look_at_camera(eye: np.ndarray, target: np.ndarray, up: np.ndarray,
                   width: int, height: int, fovy: float) -> Camera:
    """A camera at `eye` looking at `target`, image rows along the side of
    `up` opposite to it (the viewer's and trajectories' free camera)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    dn = np.cross(fwd, right)
    R = np.stack([right, dn, fwd], axis=1)
    T = -R.T @ eye
    fovx = 2 * math.atan(math.tan(fovy / 2) * width / height)
    return Camera(uid=0, R=R, T=T, fovx=fovx, fovy=fovy, width=width,
                  height=height)

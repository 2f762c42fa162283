"""Package filtered MVS outputs for training.

Port of relightable3dgaussian_tpu/mvs/prepare.py (numpy, float64, the same
arithmetic): world-space normals from the depth maps (central differences
on unprojected camera-space points, the reference's kornia
depth_to_normals) and the on-disk layouts the dataset readers expect:
`extra/depths/{name}.tiff`, `extra/normals/{name}.pfm` and
`extra/masks/{name}.png` for Blender scenes, or `inputs/{depths,normals,
pmasks}` for NeILF scenes. TIFFs and PNGs go through the port's own
writers (scene/image_io.py), which the JAX package's readers read back.
"""
from __future__ import annotations

import os

import numpy as np

from ..scene.image_io import save_pfm, write_png, write_tiff_float
from .formats import MVSCamera


def depth_to_normal(depth: np.ndarray, cam: MVSCamera,
                    world_space: bool = True, smooth: int = 7) -> np.ndarray:
    """[H, W] depth → [H, W, 3] unit normals (0 where the depth is invalid).

    Central differences on unprojected camera-space points, n =
    normalize(dp/dx × dp/dy), turned toward the camera. The depth is
    box-smoothed over a `smooth` window first: per-pixel estimation noise
    (~1% of depth) would otherwise rule the 1-px differences.
    """
    H, W = depth.shape
    valid0 = depth > 1e-9
    if smooth and smooth > 1:
        k = np.ones(smooth) / smooth

        def box(a):
            a = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, a)
            return np.apply_along_axis(lambda r: np.convolve(r, k, "same"),
                                       0, a)

        num = box(depth * valid0)
        den = box(valid0.astype(np.float64))
        depth = np.where(valid0, num / np.maximum(den, 1e-9), 0.0)
    K = np.asarray(cam.intrinsic, np.float64)
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    rays = np.linalg.inv(K) @ np.stack(
        [xs.ravel(), ys.ravel(), np.ones(H * W)])
    p = (rays * depth.reshape(1, -1)).T.reshape(H, W, 3)

    dx = np.zeros_like(p)
    dy = np.zeros_like(p)
    dx[:, 1:-1] = (p[:, 2:] - p[:, :-2]) * 0.5
    dy[1:-1, :] = (p[2:, :] - p[:-2, :]) * 0.5
    n = np.cross(dx, dy)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(norm > 1e-12, n / np.maximum(norm, 1e-12), 0.0)
    # toward the camera, which looks along +z (COLMAP convention)
    flip = (n * p).sum(-1, keepdims=True) > 0
    n = np.where(flip, -n, n)
    if world_space:
        R = np.asarray(cam.extrinsic, np.float64)[:3, :3]
        n = n @ R  # camera → world on row vectors (R^T n)
    valid = (depth > 1e-9)[..., None]
    return np.where(valid, n, 0.0).astype(np.float32)


def _masked(depths, masks, cams, name):
    """The depth zeroed outside the mask and its normals: the normals come
    from the UNMASKED depth and are zeroed afterwards, as differencing
    across mask holes would invalidate every kept pixel next to a rejected
    one."""
    raw = np.asarray(depths[name], np.float32)
    m = np.asarray(masks[name])
    n = depth_to_normal(raw, cams[name]) * m[..., None]
    return raw * m, n.astype(np.float32), (m * 255).astype(np.uint8)


def prepare_blender_extra(scene_dir: str, names: list[str],
                          depths: dict[str, np.ndarray],
                          masks: dict[str, np.ndarray],
                          cams: dict[str, MVSCamera]) -> None:
    """Write `extra/depths/{name}.tiff`, `extra/normals/{name}.pfm` and
    `extra/masks/{name}.png` for the Blender reader's MVS branch."""
    dirs = [os.path.join(scene_dir, "extra", d)
            for d in ("depths", "normals", "masks")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    for name in names:
        base = os.path.basename(name)
        depth, normal, mask = _masked(depths, masks, cams, name)
        write_tiff_float(os.path.join(dirs[0], base + ".tiff"), depth)
        save_pfm(os.path.join(dirs[1], base + ".pfm"), normal)
        write_png(os.path.join(dirs[2], base + ".png"), mask)


def prepare_neilf_inputs(out_dir: str, names: list[str],
                         depths: dict[str, np.ndarray],
                         masks: dict[str, np.ndarray],
                         cams: dict[str, MVSCamera]) -> None:
    """Write the NeILF `inputs/{depths,normals,pmasks}` layout (read by the
    NeILF reader of scene/dataset_readers.py)."""
    dirs = [os.path.join(out_dir, "inputs", d)
            for d in ("depths", "normals", "pmasks")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    for name in names:
        base = os.path.basename(name)
        depth, normal, mask = _masked(depths, masks, cams, name)
        save_pfm(os.path.join(dirs[0], base + ".pfm"), depth)
        save_pfm(os.path.join(dirs[1], base + ".pfm"), normal)
        write_png(os.path.join(dirs[2], base + ".png"), mask)

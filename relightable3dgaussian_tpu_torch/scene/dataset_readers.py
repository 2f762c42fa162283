"""Dataset readers: COLMAP / Blender / NeILF / Synthetic4Relight / StanfordORB.

Port of relightable3dgaussian_tpu/scene/dataset_readers.py, numpy only: the
five loaders of the reference, each returning a SceneInfo(point_cloud,
train/test cameras, nerf_normalization, ply_path), with the JAX package's
conventions:
  * COLMAP: PINHOLE / SIMPLE_PINHOLE only, optional masks/ dir, DTU fixed
    test split [2,12,17,30,34], llffhold=8 otherwise (lines 150-190).
  * Blender: transforms_{train,test}.json, OpenGL→COLMAP axis flip, alpha
    composite over bg; the test views take depth and normal maps from an
    extra/ MVS directory where there is one (`extra/depths/*.tiff` and
    `extra/normals/*.pfm`, written by cli/mvs.py or the JAX package's).
  * NeILF: inputs/sfm_scene.json with bbox rescale + pmasks (lines 315-432).
  * Synthetic4Relight: EXR train / RGBA png test with _mask companions.
  * StanfordORB: 512x512 resize, EXR images.
Missing-SfM datasets get a random 100k-point init (`_random_pcd`: numpy
`default_rng(0)`), written into the dataset directory as the JAX package
writes it, so both packages start from the same file.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import NamedTuple

import numpy as np

from ..utils.graphics import focal2fov, fov2focal, world_to_view
from ..utils.sh import C0
from . import colmap_loader as colmap
from .image_io import (load_depth, load_img_rgb, load_mask_bool, load_pfm,
                       resize_image)
from .ply_io import fetch_point_cloud, store_point_cloud


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    FovX: float | None
    FovY: float | None
    image: np.ndarray | None
    image_path: str
    image_name: str
    width: int
    height: int
    image_mask: np.ndarray | None = None
    depth: np.ndarray | None = None
    normal: np.ndarray | None = None
    fx: float | None = None
    fy: float | None = None
    cx: float | None = None
    cy: float | None = None


class BasicPointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


class SceneInfo(NamedTuple):
    point_cloud: BasicPointCloud | None
    train_cameras: list[CameraInfo]
    test_cameras: list[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_infos: list[CameraInfo]) -> dict:
    """Scene extent = 1.1 x the diagonal of camera centers (nerf++ style)."""
    centers = np.stack([np.linalg.inv(world_to_view(c.R, c.T))[:3, 3]
                        for c in cam_infos])
    avg = centers.mean(0)
    radius = float(np.linalg.norm(centers - avg, axis=-1).max() * 1.1)
    return {"translate": -avg, "radius": radius}


def _fetch_or_none(ply_path: str) -> BasicPointCloud | None:
    """The point cloud, or None where the file is missing or not a PLY."""
    try:
        xyz, col, nrm = fetch_point_cloud(ply_path)
    except (OSError, ValueError, KeyError):
        return None
    return BasicPointCloud(points=xyz, colors=col, normals=nrm)


def _random_pcd(ply_path: str, num_pts: int, lo: float, hi: float,
                force: bool = False) -> None:
    if os.path.exists(ply_path) and not force:
        return
    print(f"Generating random point cloud ({num_pts})...")
    rng = np.random.default_rng(0)
    xyz = rng.random((num_pts, 3)) * (hi - lo) + lo
    shs = rng.random((num_pts, 3)) / 255.0
    normals = rng.standard_normal(xyz.shape)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    store_point_cloud(ply_path, xyz, (shs * C0 + 0.5) * 255, normals)


# ---------------------------------------------------------------------------
# COLMAP
# ---------------------------------------------------------------------------

def read_colmap_scene(path: str, images_dir: str = "images",
                      eval_split: bool = False, llffhold: int = 8,
                      debug: bool = False) -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    try:
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    cam_infos = []
    folder = os.path.join(path, images_dir)
    for idx, key in enumerate(sorted(extr, key=lambda k: extr[k].name)):
        im = extr[key]
        cam = intr[im.camera_id]
        R = colmap.qvec2rotmat(im.qvec).T
        T = np.array(im.tvec)
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
            cx, cy = cam.params[1], cam.params[2]
        elif cam.model == "PINHOLE":
            fx, fy = cam.params[0], cam.params[1]
            cx, cy = cam.params[2], cam.params[3]
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {cam.model}: only "
                "undistorted PINHOLE/SIMPLE_PINHOLE datasets are supported")
        image_path = os.path.join(folder, os.path.basename(im.name))
        image = load_img_rgb(image_path)[..., :3]
        mask_path = os.path.join(path, "masks", os.path.basename(im.name))
        if os.path.exists(mask_path):
            mask = 1.0 - load_mask_bool(mask_path) / 255.0
            image = image * mask[..., None]
        else:
            mask = np.ones(image.shape[:2], np.float32)
        cam_infos.append(CameraInfo(
            uid=cam.id, R=R, T=T,
            FovX=focal2fov(fx, cam.width), FovY=focal2fov(fy, cam.height),
            fx=fx, fy=fy, cx=cx, cy=cy, image=image, image_mask=mask,
            image_path=image_path, image_name=Path(image_path).stem,
            width=cam.width, height=cam.height))
        if debug and idx >= 5:
            break

    if eval_split:
        if "dtu" in path.lower():
            test_idx = [2, 12, 17, 30, 34]
        else:
            test_idx = list(range(0, len(cam_infos), llffhold))
        train = [c for i, c in enumerate(cam_infos) if i not in test_idx]
        test = [c for i, c in enumerate(cam_infos) if i in test_idx]
    else:
        train, test = cam_infos, []

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(
                os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(
                os.path.join(sparse, "points3D.txt"))
        store_point_cloud(ply_path, xyz, rgb)

    return SceneInfo(point_cloud=_fetch_or_none(ply_path),
                     train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path)


# ---------------------------------------------------------------------------
# Blender (NeRF-synthetic)
# ---------------------------------------------------------------------------

def _blender_pose(frame: dict):
    c2w = np.array(frame["transform_matrix"], np.float64)
    c2w[:3, 1:3] *= -1  # OpenGL → COLMAP axes
    w2c = np.linalg.inv(c2w)
    return w2c[:3, :3].T, w2c[:3, 3]


def _read_transforms(path: str, fname: str, white_background: bool,
                     extension: str = ".png", read_mvs: bool = False,
                     debug: bool = False) -> list[CameraInfo]:
    with open(os.path.join(path, fname)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    mvs_dir = os.path.join(path, "extra")
    cam_infos = []
    for idx, frame in enumerate(contents["frames"]):
        image_path = os.path.join(path, frame["file_path"] + extension)
        R, T = _blender_pose(frame)
        image = load_img_rgb(image_path)
        bg = np.ones(3) if white_background else np.zeros(3)
        mask = np.ones(image.shape[:2], np.float32)
        if image.shape[-1] == 4:
            mask = image[..., 3]
            image = image[..., :3] * mask[..., None] + bg * (1 - mask[..., None])
        depth = normal = None
        if read_mvs and os.path.isdir(mvs_dir):
            base = os.path.basename(frame["file_path"])
            depth = load_depth(os.path.join(mvs_dir, "depths", base + ".tiff"))
            normal = load_pfm(os.path.join(mvs_dir, "normals", base + ".pfm"))
            depth = depth * mask
            normal = normal * mask[..., None]
        fovy = focal2fov(fov2focal(fovx, image.shape[0]), image.shape[1])
        cam_infos.append(CameraInfo(
            uid=idx, R=R, T=T, FovX=fovx, FovY=fovy, image=image[..., :3],
            image_mask=mask, depth=depth, normal=normal,
            image_path=image_path, image_name=Path(image_path).stem,
            width=image.shape[1], height=image.shape[0]))
        if debug and idx >= 5:
            break
    return cam_infos


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = False, extension: str = ".png",
                       debug: bool = False) -> SceneInfo:
    train = _read_transforms(path, "transforms_train.json", white_background,
                             extension, debug=debug)
    test = (_read_transforms(path, "transforms_test.json", white_background,
                             extension, read_mvs=True, debug=debug)
            if eval_split else [])
    ply_path = os.path.join(path, "points3d.ply")
    _random_pcd(ply_path, 100_000, -1.3, 1.3)
    return SceneInfo(point_cloud=_fetch_or_none(ply_path),
                     train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path)


# ---------------------------------------------------------------------------
# NeILF (DTU / TnT preprocessed)
# ---------------------------------------------------------------------------

def read_neilf_scene(path: str, white_background: bool = False,
                     eval_split: bool = False, debug: bool = False) -> SceneInfo:
    inputs = os.path.join(path, "inputs")
    with open(os.path.join(inputs, "sfm_scene.json")) as f:
        sfm = json.load(f)
    bbox = np.array(sfm["bbox"]["transform"]).reshape(4, 4).copy()
    bbox[[0, 1, 2], [0, 1, 2]] = bbox[[0, 1, 2], [0, 1, 2]].max() / 2
    bbox_inv = np.linalg.inv(bbox)

    image_list = sfm["image_path"]["file_paths"]
    valid = [2, 12, 17, 30, 34] if eval_split else []

    train, test = [], []
    for i, (index, info) in enumerate(sfm["camera_track_map"]["images"].items()):
        if info["flg"] != 2:
            continue
        intr = info["camera"]["intrinsic"]
        fx, fy = intr["focal"]
        cx, cy = intr["ppt"]
        extrinsic = np.array(info["camera"]["extrinsic"]).reshape(4, 4)
        c2w = np.linalg.inv(extrinsic)
        c2w[:3, 3] = (np.append(c2w[:3, 3], 1.0) @ bbox_inv.T)[:3]
        w2c = np.linalg.inv(c2w)
        R, T = w2c[:3, :3].T, w2c[:3, 3]

        image_path = os.path.join(path, image_list[index])
        image = load_img_rgb(image_path)[..., :3]
        mask_name = os.path.splitext(os.path.basename(image_list[index]))[0] + ".png"
        mask_path = os.path.join(path, "pmasks", mask_name)
        if os.path.exists(mask_path):
            mask = load_mask_bool(mask_path) / 255.0
            image = image * mask[..., None]
        else:
            mask = np.ones(image.shape[:2], np.float32)
        info_cam = CameraInfo(
            uid=int(index), R=R, T=T,
            FovX=focal2fov(fx, image.shape[1]),
            FovY=focal2fov(fy, image.shape[0]),
            fx=fx, fy=fy, cx=cx, cy=cy, image=image, image_mask=mask,
            image_path=image_path, image_name=Path(image_path).stem,
            width=image.shape[1], height=image.shape[0])
        (test if int(index) in valid else train).append(info_cam)
        if debug and i >= 5:
            break

    org_ply = os.path.join(inputs, "model", "sparse.ply")
    ply_path = os.path.join(inputs, "model", "sparse_bbx_scale.ply")
    xyz, col, nrm = fetch_point_cloud(org_ply)
    xyz1 = np.concatenate([xyz, np.ones_like(xyz[:, :1])], -1)
    xyz_scaled = (xyz1 @ np.linalg.inv(bbox).T)[:, :3]
    store_point_cloud(ply_path, xyz_scaled, col * 255, nrm)
    return SceneInfo(point_cloud=_fetch_or_none(ply_path),
                     train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path)


# ---------------------------------------------------------------------------
# Synthetic4Relight
# ---------------------------------------------------------------------------

def _read_transforms_s4r(path: str, fname: str, white_background: bool,
                         extension: str, debug: bool) -> list[CameraInfo]:
    with open(os.path.join(path, fname)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    cam_infos = []
    for idx, frame in enumerate(contents["frames"]):
        image_path = os.path.join(path, frame["file_path"] + extension)
        mask_path = image_path.replace("_rgb.exr", "_mask.png")
        R, T = _blender_pose(frame)
        image = load_img_rgb(image_path)
        if extension == "_rgba.png" and image.shape[-1] == 4:
            mask = image[..., 3]
        else:
            mask = load_mask_bool(mask_path) / 255.0 \
                if os.path.exists(mask_path) else np.ones(image.shape[:2],
                                                          np.float32)
        bg = np.ones(3) if white_background else np.zeros(3)
        image = image[..., :3] * mask[..., None] + bg * (1 - mask[..., None])
        fovy = focal2fov(fov2focal(fovx, image.shape[0]), image.shape[1])
        cam_infos.append(CameraInfo(
            uid=idx, R=R, T=T, FovX=fovx, FovY=fovy, image=image,
            image_mask=mask, image_path=image_path,
            image_name=Path(image_path).stem,
            width=image.shape[1], height=image.shape[0]))
        if debug and idx >= 5:
            break
    return cam_infos


def read_synthetic4relight_scene(path: str, white_background: bool = False,
                                 eval_split: bool = False,
                                 debug: bool = False) -> SceneInfo:
    train = _read_transforms_s4r(path, "transforms_train.json",
                                 white_background, "_rgb.exr", debug)
    test = (_read_transforms_s4r(path, "transforms_test.json",
                                 white_background, "_rgba.png", debug)
            if eval_split else [])
    ply_path = os.path.join(path, "points3d.ply")
    _random_pcd(ply_path, 100_000, -1.3, 1.3)
    return SceneInfo(point_cloud=_fetch_or_none(ply_path),
                     train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path)


# ---------------------------------------------------------------------------
# Stanford-ORB
# ---------------------------------------------------------------------------

def _read_transforms_orb(path: str, fname: str, white_background: bool,
                         size: int, debug: bool) -> list[CameraInfo]:
    with open(os.path.join(path, fname)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    cam_infos = []
    for idx, frame in enumerate(contents["frames"]):
        stem = os.path.join(path, frame["file_path"])
        image_path = stem + (".png" if os.path.exists(stem + ".png")
                             else ".exr")
        mask_item = frame["file_path"].replace("test", "test_mask") \
            .replace("train", "train_mask")
        mask_stem = os.path.join(path, mask_item)
        mask_path = mask_stem + (".png" if os.path.exists(mask_stem + ".png")
                                 else ".exr")
        R, T = _blender_pose(frame)
        image = load_img_rgb(image_path)[..., :3]
        mask = load_mask_bool(mask_path) / 255.0
        image = resize_image(image, size, size)
        mask = resize_image(mask, size, size)
        bg = np.ones(3) if white_background else np.zeros(3)
        image = image * mask[..., None] + bg * (1 - mask[..., None])
        fovy = focal2fov(fov2focal(fovx, image.shape[0]), image.shape[1])
        cam_infos.append(CameraInfo(
            uid=idx, R=R, T=T, FovX=fovx, FovY=fovy, image=image,
            image_mask=mask, image_path=image_path,
            image_name=Path(image_path).stem,
            width=image.shape[1], height=image.shape[0]))
        if debug and idx >= 5:
            break
    return cam_infos


def read_stanford_orb_scene(path: str, white_background: bool = False,
                            eval_split: bool = False, size: int = 512,
                            debug: bool = False) -> SceneInfo:
    train = _read_transforms_orb(path, "transforms_train.json",
                                 white_background, size, debug)
    test = (_read_transforms_orb(path, "transforms_test.json",
                                 white_background, size, debug)
            if eval_split else [])
    ply_path = os.path.join(path, "points3d.ply")
    _random_pcd(ply_path, 100_000, -0.5, 0.5, force=True)
    return SceneInfo(point_cloud=_fetch_or_none(ply_path),
                     train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path)


scene_load_callbacks = {
    "Colmap": read_colmap_scene,
    "Blender": read_blender_scene,
    "Synthetic4Relight": read_synthetic4relight_scene,
    "NeILF": read_neilf_scene,
    "StanfordORB": read_stanford_orb_scene,
}

"""Scene: dataset dispatch, camera lists, the initial point cloud, PLY export.

Port of relightable3dgaussian_tpu/scene/__init__.py (the reference's
scene/__init__.py): sniffs the dataset type by directory layout and path
keywords, loads the cameras at the requested resolution scales, records
input.ply and cameras.json next to the model, and exposes `cameras_extent`
(the nerf++ radius) for densification. With `shuffle` the camera lists are
shuffled by Python's `random`, unseeded, as in the JAX package (seed it with
`random.seed` for a repeatable order).
"""
from __future__ import annotations

import json
import os
import random

import numpy as np

from . import ply_io
from .cameras import Camera, camera_to_json, load_camera
from .dataset_readers import SceneInfo, scene_load_callbacks


def sniff_scene_type(source_path: str) -> str:
    if os.path.exists(os.path.join(source_path, "sparse")):
        return "Colmap"
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        if "stanford_orb" in source_path:
            return "StanfordORB"
        if "Synthetic4Relight" in source_path:
            return "Synthetic4Relight"
        return "Blender"
    if os.path.exists(os.path.join(source_path, "inputs/sfm_scene.json")):
        return "NeILF"
    raise ValueError(f"could not recognize scene type at {source_path}")


def search_max_iteration(folder: str) -> int | None:
    if not os.path.isdir(folder):
        return None
    its = [int(d.split("_")[-1]) for d in os.listdir(folder)
           if d.startswith("iteration_")]
    return max(its) if its else None


class Scene:
    def __init__(self, source_path: str, model_path: str, *,
                 images: str = "images", white_background: bool = False,
                 eval_split: bool = False, resolution: int = -1,
                 resolution_scales=(1.0,), shuffle: bool = True,
                 debug: bool = False):
        self.source_path = source_path
        self.model_path = model_path

        kind = sniff_scene_type(source_path)
        reader = scene_load_callbacks[kind]
        if kind == "Colmap":
            self.scene_info: SceneInfo = reader(
                source_path, images, eval_split, debug=debug)
        else:
            self.scene_info = reader(source_path, white_background,
                                     eval_split, debug=debug)

        if model_path:
            os.makedirs(model_path, exist_ok=True)
            with open(self.scene_info.ply_path, "rb") as src, \
                    open(os.path.join(model_path, "input.ply"), "wb") as dst:
                dst.write(src.read())
            cams = (list(self.scene_info.test_cameras)
                    + list(self.scene_info.train_cameras))
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump([camera_to_json(i, c) for i, c in enumerate(cams)],
                          f)

        train_infos = list(self.scene_info.train_cameras)
        test_infos = list(self.scene_info.test_cameras)
        if shuffle:
            random.shuffle(train_infos)
            random.shuffle(test_infos)

        self.cameras_extent = self.scene_info.nerf_normalization["radius"]
        self.train_cameras: dict[float, list[Camera]] = {}
        self.test_cameras: dict[float, list[Camera]] = {}
        for scale in resolution_scales:
            self.train_cameras[scale] = [
                load_camera(c, resolution, scale) for c in train_infos]
            self.test_cameras[scale] = [
                load_camera(c, resolution, scale) for c in test_infos]

    def get_train_cameras(self, scale: float = 1.0) -> list[Camera]:
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0) -> list[Camera]:
        return self.test_cameras[scale]

    def save(self, iteration: int, fields: dict[str, np.ndarray]) -> None:
        """Export the gaussians (`GaussianModel.to_numpy()`) as
        point_cloud/iteration_N/point_cloud.ply."""
        path = os.path.join(self.model_path, "point_cloud",
                            f"iteration_{iteration}", "point_cloud.ply")
        ply_io.save_gaussian_ply(path, fields)

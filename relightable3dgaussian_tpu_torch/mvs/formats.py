"""MVSNet interchange formats: `*_cam.txt`, `pair.txt` and PFM.

Port of relightable3dgaussian_tpu/mvs/formats.py; the files are written
byte for byte as there. A cam file holds a 4x4 world→camera extrinsic, a
3x3 intrinsic, and a `depth_min interval depth_num depth_max` line;
pair.txt holds each view's ranked source list (the reference tooling's
layout, vismvsnet/colmap2mvsnet.py and utils/io_utils.py).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from ..scene import image_io


class MVSCamera(NamedTuple):
    extrinsic: np.ndarray   # [4, 4] world → camera
    intrinsic: np.ndarray   # [3, 3]
    depth_min: float
    depth_interval: float
    depth_num: float
    depth_max: float


def write_cam_txt(path: str, cam: MVSCamera) -> None:
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in np.asarray(cam.extrinsic, np.float64):
            f.write(" ".join(str(v) for v in row) + " \n")
        f.write("\nintrinsic\n")
        for row in np.asarray(cam.intrinsic, np.float64):
            f.write(" ".join(str(v) for v in row) + " \n")
        f.write(f"\n{cam.depth_min:f} {cam.depth_interval:f} "
                f"{cam.depth_num:f} {cam.depth_max:f}\n")


def load_cam_txt(path: str) -> MVSCamera:
    with open(path) as f:
        words = f.read().split()
    if words[0] != "extrinsic" or words[17] != "intrinsic":
        raise ValueError(f"{path}: not an MVSNet cam file")
    ext = np.array([float(v) for v in words[1:17]]).reshape(4, 4)
    intr = np.array([float(v) for v in words[18:27]]).reshape(3, 3)
    rest = [float(v) for v in words[27:31]]
    while len(rest) < 4:
        rest.append(0.0)
    return MVSCamera(ext, intr, rest[0], rest[1], rest[2], rest[3])


def write_pair_txt(path: str, view_sel: list[list[tuple[int, float]]]) -> None:
    """view_sel[i] = ranked [(src_index, score), ...] for reference view i."""
    with open(path, "w") as f:
        f.write(f"{len(view_sel)}\n")
        for i, pairs in enumerate(view_sel):
            f.write(f"{i}\n{len(pairs)} ")
            for j, s in pairs:
                f.write(f"{j} {s:f} ")
            f.write("\n")


def load_pair_txt(path: str) -> list[list[tuple[int, float]]]:
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines()]
    out = []
    for i in range(int(lines[0])):
        toks = lines[2 + 2 * i].split()
        out.append([(int(toks[1 + 2 * j]), float(toks[2 + 2 * j]))
                    for j in range(int(toks[0]))])
    return out


def save_pfm(path: str, data: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    image_io.save_pfm(path, data)


def load_pfm(path: str) -> np.ndarray:
    return np.asarray(image_io.load_pfm(path))

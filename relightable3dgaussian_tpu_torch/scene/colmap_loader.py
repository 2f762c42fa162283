"""COLMAP sparse-reconstruction parsers (binary and text).

The port's own copy of relightable3dgaussian_tpu/scene/colmap_loader.py
(numpy only; the port imports nothing of the JAX package): the readers of
cameras, images and points3D, binary layouts after the public COLMAP spec,
and the binary writers, which write the JAX package's bytes (a point's
track is written empty, as there).
"""
from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np

# COLMAP camera models: id → (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, nparams = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * nparams))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * npts),
                                 dtype=[("xy", "<f8", 2), ("id", "<i8")])
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode(),
                                      data["xy"].copy(), data["id"].copy())
    return images


def read_points3d_binary(path: str, with_ids: bool = False):
    """→ (xyz [N,3], rgb [N,3] uint8, errors [N][, point ids [N]])."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        ids = np.empty(n, np.int64)
        for i in range(n):
            pid, x, y, z, r, g, b, e = _read(f, "<QdddBBBd")
            ids[i] = pid
            xyz[i] = (x, y, z)
            rgb[i] = (r, g, b)
            err[i] = e
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    if with_ids:
        return xyz, rgb, err, ids
    return xyz, rgb, err


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        el = line.split()
        cams[int(el[0])] = ColmapCamera(
            int(el[0]), el[1], int(el[2]), int(el[3]),
            np.array([float(x) for x in el[4:]]))
    return cams


def read_images_text(path: str) -> dict[int, ColmapImage]:
    images = {}
    lines = [ln.strip() for ln in open(path)
             if ln.strip() and not ln.startswith("#")]
    for meta, pts in zip(lines[0::2], lines[1::2]):
        el = meta.split()
        iid = int(el[0])
        qvec = np.array([float(x) for x in el[1:5]])
        tvec = np.array([float(x) for x in el[5:8]])
        pel = pts.split()
        xys = np.array([float(x) for x in pel]).reshape(-1, 3) \
            if pel else np.zeros((0, 3))
        images[iid] = ColmapImage(iid, qvec, tvec, int(el[8]), el[9],
                                  xys[:, :2], xys[:, 2].astype(np.int64))
    return images


def read_points3d_text(path: str, with_ids: bool = False):
    xyz, rgb, err, ids = [], [], [], []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        el = line.split()
        ids.append(int(el[0]))
        xyz.append([float(x) for x in el[1:4]])
        rgb.append([int(x) for x in el[4:7]])
        err.append(float(el[7]))
    out = (np.array(xyz), np.array(rgb, np.uint8), np.array(err))
    if with_ids:
        return out + (np.array(ids, np.int64),)
    return out


# Binary writers

def write_cameras_binary(path: str, cams: dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            f.write(struct.pack("<iiQQ", c.id, MODEL_IDS[c.model],
                                c.width, c.height))
            f.write(struct.pack("<" + "d" * len(c.params), *c.params))


def write_images_binary(path: str, images: dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            obs = np.empty(len(im.xys), [("xy", "<f8", 2), ("id", "<i8")])
            obs["xy"] = np.asarray(im.xys, np.float64).reshape(-1, 2)
            obs["id"] = np.asarray(im.point3d_ids).astype(np.int64)
            f.write(obs.tobytes())


def write_points3d_binary(path: str, xyz: np.ndarray, rgb: np.ndarray,
                          err: np.ndarray | None = None) -> None:
    """Points with ids 0..N-1 and empty tracks."""
    err = np.zeros(len(xyz)) if err is None else err
    rec = np.empty(len(xyz), [("id", "<u8"), ("xyz", "<f8", 3),
                              ("rgb", "u1", 3), ("err", "<f8"),
                              ("track", "<u8")])
    rec["id"] = np.arange(len(xyz))
    rec["xyz"] = np.asarray(xyz, np.float64).reshape(-1, 3)
    rec["rgb"] = np.asarray(rgb).astype(np.uint8).reshape(-1, 3)
    rec["err"] = err
    rec["track"] = 0
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        f.write(rec.tobytes())

"""COLMAP sparse model → MVSNet cams + pair list.

Port of relightable3dgaussian_tpu/mvs/colmap_to_mvs.py (numpy, the same
files): each view's depth range from the 1%/99% quantiles of its observed
sparse points' depths, and pairwise view-selection scores
Σ_p exp(-(θ-θ0)²/(2σ²)) over shared points (σ = σ1 below θ0, σ2 above),
the semantics of the reference's colmap2mvsnet.py.
"""
from __future__ import annotations

import os

import numpy as np

from ..scene import colmap_loader as colmap
from .formats import MVSCamera, write_cam_txt, write_pair_txt


def _intrinsic_3x3(cam) -> np.ndarray:
    p = cam.params
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                     "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    else:  # PINHOLE / OPENCV / ... lead with fx fy cx cy
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


def _pair_score(pids_i, pids_j, pid2row, xyz, ci, cj,
                theta0: float, sigma1: float, sigma2: float) -> float:
    shared = np.intersect1d(pids_i, pids_j, assume_unique=False)
    shared = shared[shared >= 0]
    if shared.size == 0:
        return 0.0
    rows = np.array([pid2row[p] for p in shared if p in pid2row], np.int64)
    if rows.size == 0:
        return 0.0
    p = xyz[rows]
    a = ci[None, :] - p
    b = cj[None, :] - p
    cos = (a * b).sum(-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-12)
    theta = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    sigma = np.where(theta <= theta0, sigma1, sigma2)
    return float(np.exp(-((theta - theta0) ** 2) / (2 * sigma ** 2)).sum())


def _read_model(model_dir: str):
    if os.path.exists(os.path.join(model_dir, "cameras.bin")):
        return (colmap.read_cameras_binary(
                    os.path.join(model_dir, "cameras.bin")),
                colmap.read_images_binary(
                    os.path.join(model_dir, "images.bin")),
                colmap.read_points3d_binary(
                    os.path.join(model_dir, "points3D.bin"), with_ids=True))
    return (colmap.read_cameras_text(os.path.join(model_dir, "cameras.txt")),
            colmap.read_images_text(os.path.join(model_dir, "images.txt")),
            colmap.read_points3d_text(
                os.path.join(model_dir, "points3D.txt"), with_ids=True))


def colmap_to_mvs(dense_folder: str, max_d: int = 256,
                  interval_scale: float = 1.0, theta0: float = 5.0,
                  sigma1: float = 1.0, sigma2: float = 10.0,
                  num_pairs: int = 10,
                  model_subdir: str = "sparse/0") -> list[str]:
    """Write `cams/{name}_cam.txt`, `pair.txt` and `names.txt` under
    dense_folder. Returns the image names (without extension) in pair-index
    order (COLMAP image-id order)."""
    cams, imgs, (xyz, _, _, pids) = _read_model(
        os.path.join(dense_folder, model_subdir))
    ids = sorted(imgs)
    pid2row = {int(p): i for i, p in enumerate(pids)}
    extr, centers = {}, {}
    for im_id in ids:
        im = imgs[im_id]
        R = colmap.qvec2rotmat(np.asarray(im.qvec, np.float64))
        e = np.eye(4)
        e[:3, :3] = R
        e[:3, 3] = im.tvec
        extr[im_id] = e
        centers[im_id] = -R.T @ np.asarray(im.tvec, np.float64)

    cam_dir = os.path.join(dense_folder, "cams")
    os.makedirs(cam_dir, exist_ok=True)
    names = []
    for im_id in ids:
        im = imgs[im_id]
        rows = np.array([pid2row[p] for p in im.point3d_ids
                         if p >= 0 and p in pid2row], np.int64)
        if rows.size:
            pw = np.concatenate([xyz[rows],
                                 np.ones((rows.size, 1))], axis=1)
            zs = np.sort((pw @ extr[im_id].T)[:, 2])
            dmin = float(zs[int(len(zs) * 0.01)])
            dmax = float(zs[min(int(len(zs) * 0.99), len(zs) - 1)])
        else:
            dmin, dmax = 0.5, 10.0
        dmin = max(dmin, 1e-3)
        dmax = max(dmax, dmin * 1.01)
        interval = (dmax - dmin) / (max_d - 1) / interval_scale
        name = os.path.splitext(im.name)[0]
        names.append(name)
        write_cam_txt(
            os.path.join(cam_dir, f"{name}_cam.txt"),
            MVSCamera(extr[im_id], _intrinsic_3x3(cams[im.camera_id]),
                      dmin, interval, float(max_d), dmax))

    score = np.zeros((len(ids), len(ids)))
    for a in range(len(ids)):
        for b in range(a + 1, len(ids)):
            s = _pair_score(imgs[ids[a]].point3d_ids,
                            imgs[ids[b]].point3d_ids, pid2row, xyz,
                            centers[ids[a]], centers[ids[b]],
                            theta0, sigma1, sigma2)
            score[a, b] = score[b, a] = s
    view_sel = []
    for i in range(len(ids)):
        order = np.argsort(score[i])[::-1]
        # a view is never its own source, nor one it shares no point with
        sel = [(int(k), float(score[i, k])) for k in order
               if int(k) != i and score[i, k] > 0.0][:num_pairs]
        view_sel.append(sel)
    write_pair_txt(os.path.join(dense_folder, "pair.txt"), view_sel)
    # pair.txt holds indices into this id order: names.txt keeps it
    with open(os.path.join(dense_folder, "names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return names

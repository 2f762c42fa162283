"""Checkpoints in the JAX package's named-npz format.

Port of `relightable3dgaussian_tpu/train/checkpoint.py`.

A file holds `__iteration__`, one `params.<field>` array per `GaussianParams`
leaf and one `aux.<field>` array per `GaussianAux` leaf, padded to a capacity
with `aux.active` marking the live rows. `load_checkpoint` reads the stage-1
fields into a `GaussianModel` of the active rows (a stage-1 file's zero-width
PBR leaves are ignored); `save_checkpoint` writes a file the JAX package's
`load_checkpoint` restores, so a model can go both ways.
"""
from __future__ import annotations

import os

import numpy as np

from ..models.gaussians import FIELDS, N_SH, GaussianModel

# Zero-width stage-2 leaves of a stage-1 GaussianParams (gaussians.py:180-189).
_PBR_SHAPES = {"base_color": (0, 3), "roughness": (0, 1),
               "incidents_dc": (0, 1, 3), "incidents_rest": (0, N_SH - 1, 3),
               "visibility_dc": (0, 1, 1), "visibility_rest": (0, 15, 1)}
_AUX_STATS = ("max_radii2d", "xyz_grad_accum", "normal_grad_accum", "denom",
              "weights_accum")


def _npz_path(path: str) -> str:
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        return path + ".npz"
    return path


def load_checkpoint(path: str, device="cpu") -> tuple[int, GaussianModel]:
    """Read a JAX-format checkpoint → (iteration, GaussianModel)."""
    with np.load(_npz_path(path), allow_pickle=False) as data:
        iteration = int(data["__iteration__"])
        fields = {k: data[f"params.{k}"] for k in FIELDS}
        active = data["aux.active"] if "aux.active" in data else None
    return iteration, GaussianModel.from_numpy(fields, active, device=device)


def save_checkpoint(path: str, iteration: int, model: GaussianModel) -> None:
    """Write `model` as a stage-1 JAX-format checkpoint (every row active)."""
    P = model.num_points
    out: dict[str, np.ndarray] = {"__iteration__": np.asarray(iteration)}
    for k, v in model.to_numpy().items():
        out[f"params.{k}"] = v
    for k, shape in _PBR_SHAPES.items():
        out[f"params.{k}"] = np.zeros(shape, np.float32)
    out["aux.active"] = np.ones((P,), bool)
    for k in _AUX_STATS:
        out[f"aux.{k}"] = np.zeros((P,), np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **out)

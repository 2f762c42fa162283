"""Checkpoints in the JAX package's named-npz format.

Port of `relightable3dgaussian_tpu/train/checkpoint.py`.

A file holds `__iteration__`, one `params.<field>` array per `GaussianParams`
leaf and one `aux.<field>` array per `GaussianAux` leaf, padded to a capacity
with `aux.active` marking the live rows, and, for a training state, the Adam
state as `opt_state.mu.<field>`, `opt_state.nu.<field>` and
`opt_state.count`. The port reads the stage-1 fields, the densification
statistics and the Adam moments of the active rows (a stage-1 file's
zero-width PBR leaves are ignored), and writes a file the JAX package's
`load_checkpoint` restores with every row active, so a model or a training
state can go both ways.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..models.gaussians import FIELDS, N_SH, STATS, GaussianModel
from .config import OptimizationConfig
from .optim import make_optimizer

# Zero-width stage-2 leaves of a stage-1 GaussianParams (gaussians.py:180-189).
_PBR_SHAPES = {"base_color": (0, 3), "roughness": (0, 1),
               "incidents_dc": (0, 1, 3), "incidents_rest": (0, N_SH - 1, 3),
               "visibility_dc": (0, 1, 1), "visibility_rest": (0, 15, 1)}


def _npz_path(path: str) -> str:
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        return path + ".npz"
    return path


def load_checkpoint(path: str, device="cpu") -> tuple[int, GaussianModel]:
    """Read a JAX-format checkpoint → (iteration, GaussianModel) with the
    densification statistics of the active rows (zeros where absent)."""
    with np.load(_npz_path(path), allow_pickle=False) as data:
        iteration = int(data["__iteration__"])
        fields = {k: data[f"params.{k}"] for k in FIELDS}
        active = data["aux.active"] if "aux.active" in data else None
        stats = {k: data[f"aux.{k}"] for k in STATS if f"aux.{k}" in data}
    model = GaussianModel.from_numpy(fields, active, device=device)
    keep = slice(None) if active is None else np.asarray(active, bool)
    for k, v in stats.items():
        getattr(model, k).copy_(torch.as_tensor(np.asarray(v, np.float32)[keep]))
    return iteration, model


def load_train_state(path: str, opt: OptimizationConfig,
                     spatial_lr_scale: float, device="cpu"
                     ) -> tuple[int, GaussianModel, torch.optim.Adam]:
    """Read a JAX-format training state → (iteration, model, optimizer):
    the model as `load_checkpoint` reads it and an Adam optimizer
    (train/optim.py) holding the file's moments of the active rows and its
    step count."""
    iteration, model = load_checkpoint(path, device)
    optimizer = make_optimizer(model, opt, spatial_lr_scale)
    with np.load(_npz_path(path), allow_pickle=False) as data:
        active = data["aux.active"] if "aux.active" in data else None
        keep = slice(None) if active is None else np.asarray(active, bool)
        count = float(data["opt_state.count"])
        for group in optimizer.param_groups:
            name = group["name"]
            param = group["params"][0]
            optimizer.state[param] = {
                "step": torch.tensor(count, dtype=torch.float32),
                **{key: torch.as_tensor(np.ascontiguousarray(np.asarray(
                    data[f"opt_state.{m}.{name}"], np.float32)[keep]),
                    device=param.device)
                   for key, m in (("exp_avg", "mu"), ("exp_avg_sq", "nu"))}}
    return iteration, model, optimizer


def save_checkpoint(path: str, iteration: int, model: GaussianModel,
                    optimizer: torch.optim.Optimizer | None = None) -> None:
    """Write `model` (with its densification statistics) as a stage-1
    JAX-format checkpoint, every row active; with `optimizer`, also its Adam
    state (moments of a field with no state yet are zeros)."""
    P = model.num_points
    out: dict[str, np.ndarray] = {"__iteration__": np.asarray(iteration)}
    for k, v in model.to_numpy().items():
        out[f"params.{k}"] = v
    for k, shape in _PBR_SHAPES.items():
        out[f"params.{k}"] = np.zeros(shape, np.float32)
    out["aux.active"] = np.ones((P,), bool)
    for k in STATS:
        out[f"aux.{k}"] = getattr(model, k).detach().cpu().numpy()
    if optimizer is not None:
        count = 0
        for group in optimizer.param_groups:
            name = group["name"]
            param = group["params"][0]
            state = optimizer.state.get(param, {})
            for key, m in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                out[f"opt_state.{m}.{name}"] = (
                    state[key].detach().cpu().numpy() if key in state
                    else np.zeros(tuple(param.shape), np.float32))
            if "step" in state:
                count = int(state["step"])
        for k, shape in _PBR_SHAPES.items():
            out[f"opt_state.mu.{k}"] = np.zeros(shape, np.float32)
            out[f"opt_state.nu.{k}"] = np.zeros(shape, np.float32)
        out["opt_state.count"] = np.asarray(count, np.int32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **out)

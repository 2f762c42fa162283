"""Checkpoints in the JAX package's named-npz format.

Port of `relightable3dgaussian_tpu/train/checkpoint.py`.

A file holds `__iteration__`, one `params.<field>` array per `GaussianParams`
leaf and one `aux.<field>` array per `GaussianAux` leaf, padded to a capacity
with `aux.active` marking the live rows, and, for a training state, the Adam
state as `opt_state.mu.<field>`, `opt_state.nu.<field>` and
`opt_state.count`. The port reads the parameter fields (the PBR fields when
they have a row per point; a stage-1 file's zero-width PBR leaves are
ignored), the densification statistics and the Adam moments of the active
rows, and writes a file the JAX package's `load_checkpoint` restores with
every row active, so a model or a training state can go both ways.

The stage-2 env light lives beside it in `env_light_<checkpoint name>`
(`env_checkpoint_path`), as the JAX CLI writes it: `env.env` (the raw map)
and its Adam state `env_state.mu`, `env_state.nu`, `env_state.count`.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from ..models.gaussians import PBR_SHAPES, STATS, GaussianModel
from ..models.lights import DirectLightMap
from .config import OptimizationConfig
from .optim import make_env_optimizer, make_optimizer


def _npz_path(path: str) -> str:
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        return path + ".npz"
    return path


def find_checkpoint(model_path: str, prefix: str = "chkpnt") -> str | None:
    """The `<prefix><iteration>.npz` under `model_path` with the largest
    iteration, or None where there is none."""
    if not os.path.isdir(model_path):
        return None
    best, best_it = None, -1
    pattern = re.compile(rf"^{re.escape(prefix)}(\d+)\.npz$")
    for name in os.listdir(model_path):
        m = pattern.match(name)
        if m and int(m.group(1)) > best_it:
            best_it, best = int(m.group(1)), os.path.join(model_path, name)
    return best


def load_checkpoint(path: str, device: torch.device | str = "cuda"
                    ) -> tuple[int, GaussianModel]:
    """Read a JAX-format checkpoint → (iteration, GaussianModel) on `device`
    (the card unless the caller asks for the CPU; without a card it raises)
    with the densification statistics of the active rows (zeros where
    absent)."""
    with np.load(_npz_path(path), allow_pickle=False) as data:
        iteration = int(data["__iteration__"])
        fields = {k[len("params."):]: data[k] for k in data.files
                  if k.startswith("params.")}
        active = data["aux.active"] if "aux.active" in data else None
        stats = {k: data[f"aux.{k}"] for k in STATS if f"aux.{k}" in data}
    model = GaussianModel.from_numpy(fields, active, device=device)
    keep = slice(None) if active is None else np.asarray(active, bool)
    for k, v in stats.items():
        getattr(model, k).copy_(torch.as_tensor(np.asarray(v, np.float32)[keep]))
    return iteration, model


def load_train_state(path: str, opt: OptimizationConfig,
                     spatial_lr_scale: float,
                     device: torch.device | str = "cuda"
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
    """Write `model` (with its densification statistics) as a JAX-format
    checkpoint, every row active, its PBR leaves zero-width when it has no
    PBR fields; with `optimizer`, also its Adam state (moments of a field
    with no state yet are zeros)."""
    P = model.num_points
    out: dict[str, np.ndarray] = {"__iteration__": np.asarray(iteration)}
    empty = {k: np.zeros((0,) + shape, np.float32)
             for k, shape in PBR_SHAPES.items()}
    out.update({f"params.{k}": v for k, v in empty.items()})
    for k, v in model.to_numpy().items():
        out[f"params.{k}"] = v
    out["aux.active"] = np.ones((P,), bool)
    for k in STATS:
        out[f"aux.{k}"] = getattr(model, k).detach().cpu().numpy()
    if optimizer is not None:
        for m in ("mu", "nu"):
            out.update({f"opt_state.{m}.{k}": v for k, v in empty.items()})
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
        out["opt_state.count"] = np.asarray(count, np.int32)
    _savez(path, out)


def _savez(path: str, out: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **out)


def env_checkpoint_path(checkpoint: str) -> str:
    """The env-light file beside a checkpoint: env_light_<its name>."""
    return os.path.join(os.path.dirname(checkpoint),
                        "env_light_" + os.path.basename(checkpoint))


def save_env_checkpoint(path: str, iteration: int, env: DirectLightMap,
                        env_optimizer: torch.optim.Optimizer) -> None:
    """Write the env light and its Adam state as the JAX CLI does."""
    raw = env.env.detach().cpu().numpy()
    state = env_optimizer.state.get(env.env, {})
    out = {"__iteration__": np.asarray(iteration), "env.env": raw,
           "env_state.count": np.asarray(int(state.get("step", 0)), np.int32)}
    for key, m in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        out[f"env_state.{m}"] = (state[key].detach().cpu().numpy()
                                 if key in state else np.zeros_like(raw))
    _savez(path, out)


def load_env_checkpoint(path: str, opt: OptimizationConfig,
                        device: torch.device | str = "cuda"
                        ) -> tuple[int, DirectLightMap, torch.optim.Adam]:
    """Read an env-light file → (iteration, env light, its Adam optimizer
    with the file's moments and step count) on `device`."""
    with np.load(_npz_path(path), allow_pickle=False) as data:
        iteration = int(data["__iteration__"])
        env = DirectLightMap.from_raw(torch.as_tensor(
            np.asarray(data["env.env"], np.float32), device=device))
        optimizer = make_env_optimizer(env, opt)
        optimizer.state[env.env] = {
            "step": torch.tensor(float(data["env_state.count"]),
                                 dtype=torch.float32),
            **{key: torch.as_tensor(np.asarray(data[f"env_state.{m}"],
                                               np.float32), device=device)
               for key, m in (("exp_avg", "mu"), ("exp_avg_sq", "nu"))}}
    return iteration, env, optimizer

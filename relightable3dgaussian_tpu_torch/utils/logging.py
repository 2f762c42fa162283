"""Training observability: scalar logging, image grids, snapshot dumps.

Port of relightable3dgaussian_tpu/utils/logging.py (the reference's
TensorBoard wiring, train.py:209-317):
  * MetricsLogger writes every scalar to metrics.jsonl (always) and, with
    its images, to TensorBoard where torch.utils.tensorboard can be imported;
  * save_training_vis renders a labeled grid of every image-like entry in a
    results dict to PNG;
  * debug_dump snapshots named tensors (a model's fields and statistics) to
    an npz for offline repro.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _scalar(v: Any) -> float | None:
    if isinstance(v, torch.Tensor):
        return float(v.detach()) if v.numel() == 1 else None
    if isinstance(v, (int, float, np.number)):
        return float(v)
    return None


class MetricsLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:      # tensorboard is not installed
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir)

    def scalars(self, step: int, values: dict[str, Any]) -> None:
        """Log the scalar entries of `values` (tensors of one element,
        numbers); other entries are skipped."""
        rec = {"step": step}
        for k, v in values.items():
            x = _scalar(v)
            if x is not None:
                rec[k] = x
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)

    def image(self, step: int, tag: str, img_chw) -> None:
        """Log a [C, H, W] image (numpy, or a tensor on any device),
        clipped to [0, 1], to TensorBoard where it is present."""
        if self._tb is not None:
            if isinstance(img_chw, torch.Tensor):
                img_chw = img_chw.detach().cpu().numpy()
            self._tb.add_image(tag, np.clip(np.asarray(img_chw), 0, 1), step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def _to_display(img: np.ndarray) -> np.ndarray | None:
    """Normalize an array to [H, W, 3] float for grid display, or None."""
    if img.ndim == 3 and img.shape[0] in (1, 3):
        img = np.moveaxis(img, 0, -1)
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 3):
        return None
    if img.shape[-1] == 1:
        lo, hi = float(img.min()), float(img.max())
        img = (img - lo) / (hi - lo + 1e-9)
        img = np.repeat(img, 3, -1)
    return np.clip(img.astype(np.float32), 0.0, 1.0)


def save_training_vis(path: str, results: dict[str, Any],
                      keys: list[str] | None = None,
                      cols: int = 4) -> list[str]:
    """Save a labeled grid of every image-like tensor in a results dict
    (reference save_training_vis, train.py:276-317). Returns the keys shown."""
    from ..scene.image_io import save_image_u8
    panels, names = [], []
    for k, v in results.items():
        if keys is not None and k not in keys:
            continue
        if not isinstance(v, torch.Tensor) or v.dim() not in (2, 3):
            continue
        v = v.detach().float().cpu().numpy()
        if "normal" in k and v.ndim == 3 and v.shape[0] == 3:
            v = v * 0.5 + 0.5  # [-1,1] → display range
        disp = _to_display(v)
        # Only image-like arrays (skip per-point [P, C] tensors).
        if disp is None or min(disp.shape[0], disp.shape[1]) < 8:
            continue
        panels.append(disp)
        names.append(k)
    if not panels:
        return []
    h = max(p.shape[0] for p in panels)
    w = max(p.shape[1] for p in panels)
    rows = -(-len(panels) // cols)
    grid = np.zeros((rows * h, cols * w, 3), np.float32)
    for i, p in enumerate(panels):
        r, c = divmod(i, cols)
        grid[r * h:r * h + p.shape[0], c * w:c * w + p.shape[1]] = p
    save_image_u8(path, grid)
    return names


def debug_dump(path: str, **groups: Any) -> str:
    """Snapshot named tensors to an npz: each keyword is a model (its
    parameters and buffers, as `<name>.<field>`) or a tensor."""
    out = {}
    for name, obj in groups.items():
        if isinstance(obj, torch.nn.Module):
            for k, v in [*obj.named_parameters(), *obj.named_buffers()]:
                out[f"{name}.{k}"] = v.detach().cpu().numpy()
        elif isinstance(obj, torch.Tensor):
            out[name] = obj.detach().cpu().numpy()
    path = path if path.endswith(".npz") else path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **out)
    return path

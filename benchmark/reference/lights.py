"""Environment lookup of the benchmark's plain reference: the equirect query
of the port's `models/lights.py` (bilinear `F.grid_sample`, align_corners,
zero padding), frozen here. It imports nothing of the port."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def grid_sample_bilinear(img: torch.Tensor, gx: torch.Tensor,
                         gy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img [H, W, C] at normalized coordinates gx, gy
    (same shape, in [-1, 1]) → [..., C]."""
    grid = torch.stack([gx, gy], dim=-1).reshape(1, 1, -1, 2)
    out = F.grid_sample(img.permute(2, 0, 1)[None], grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[0, :, 0].T.reshape(*gx.shape, img.shape[-1])


def equirect_query(envmap: torch.Tensor, dirs: torch.Tensor,
                   transform: torch.Tensor | None = None) -> torch.Tensor:
    """Radiance of the equirect map [H, W, 3] for unit directions [..., 3]:
    φ = arccos(clip z) − 1e-6 down the rows, θ = atan2(y, x) across the
    columns (gy = 2φ/π − 1, gx = −θ/π)."""
    shape = dirs.shape
    d = dirs.reshape(-1, 3)
    if transform is not None:
        d = d @ transform.T
    phi = torch.arccos(torch.clamp(d[:, 2], -1.0, 1.0)) - 1e-6
    theta = torch.atan2(d[:, 1], d[:, 0])
    gy = (phi / math.pi) * 2.0 - 1.0
    gx = -theta / math.pi
    return grid_sample_bilinear(envmap, gx, gy).reshape(shape)

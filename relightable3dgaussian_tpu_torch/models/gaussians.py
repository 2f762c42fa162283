"""Gaussian scene state (port of relightable3dgaussian_tpu/models/gaussians.py, stage-1 fields).

`GaussianModel` holds the raw parameters of `GaussianParams` (xyz, normal,
shs_dc, shs_rest, scaling, rotation, opacity) as `nn.Parameter`s, with the
same activations (`get_scaling`, `get_opacity`, ...). The JAX package pads
its arrays to a capacity with an `active` mask; the port keeps only the
active rows and resizes tensors instead. PBR fields, creation from a point
cloud and densification come with later slices.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

MAX_SH_DEGREE = 3
N_SH = (MAX_SH_DEGREE + 1) ** 2  # 16

# Stage-1 raw parameter fields, in GaussianParams order.
FIELDS = ("xyz", "normal", "shs_dc", "shs_rest", "scaling", "rotation",
          "opacity")


class GaussianModel(nn.Module):
    """Raw (pre-activation) stage-1 parameters of P gaussians."""

    def __init__(self, xyz: torch.Tensor, normal: torch.Tensor,
                 shs_dc: torch.Tensor, shs_rest: torch.Tensor,
                 scaling: torch.Tensor, rotation: torch.Tensor,
                 opacity: torch.Tensor):
        super().__init__()
        self.xyz = nn.Parameter(xyz)            # [P, 3]
        self.normal = nn.Parameter(normal)      # [P, 3]
        self.shs_dc = nn.Parameter(shs_dc)      # [P, 1, 3]
        self.shs_rest = nn.Parameter(shs_rest)  # [P, N_SH-1, 3]
        self.scaling = nn.Parameter(scaling)    # [P, 3] log-scale
        self.rotation = nn.Parameter(rotation)  # [P, 4] unnormalized quaternion
        self.opacity = nn.Parameter(opacity)    # [P, 1] logit

    @classmethod
    def from_numpy(cls, d: Mapping[str, np.ndarray],
                   active: np.ndarray | None = None,
                   device: torch.device | str = "cpu") -> "GaussianModel":
        """Build from the JAX `GaussianParams` fields as numpy arrays, keeping
        only the rows where `active` is set (all rows when None)."""
        keep = slice(None) if active is None else np.asarray(active, bool)
        return cls(**{k: torch.as_tensor(
            np.ascontiguousarray(np.asarray(d[k], np.float32)[keep]),
            device=device) for k in FIELDS})

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {k: getattr(self, k).detach().cpu().numpy() for k in FIELDS}

    @property
    def num_points(self) -> int:
        return self.xyz.shape[0]

    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    @property
    def get_rotation(self) -> torch.Tensor:
        q = self.rotation
        return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                               min=1e-12)

    @property
    def get_normal(self) -> torch.Tensor:
        n = self.normal
        return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                               min=1e-3)

    @property
    def get_shs(self) -> torch.Tensor:
        """[P, N_SH, 3] concatenated SH coefficients."""
        return torch.cat([self.shs_dc, self.shs_rest], dim=1)

"""Gaussian scene state (port of relightable3dgaussian_tpu/models/gaussians.py).

`GaussianModel` holds the raw parameters of `GaussianParams` (xyz, normal,
shs_dc, shs_rest, scaling, rotation, opacity and, from stage 2 on, the PBR
fields base_color, roughness, incidents_dc/rest, visibility_dc/rest) as
`nn.Parameter`s, with the same activations (`get_scaling`, `get_opacity`,
`get_base_color`, ...), and the five densification statistics of
`GaussianAux` as buffers. The JAX package pads its arrays to a capacity with
an `active` mask and moves points between slots; the port keeps only the
live rows and resizes its tensors instead, as the CUDA reference does
(`gaussian_model.py:667-750`): densification and the opacity reset replace
parameters and re-key the optimizer's state, every present field alike, so
the PBR rows stay aligned. Nothing is ever dropped for want of capacity.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.knn import mean_sq_dist_to_3nn
from ..utils.quaternions import (inverse_sigmoid, quaternion_multiply,
                                 quaternion_to_rotmat, rotmat_to_quaternion)
from ..utils.sh import rgb_to_sh

MAX_SH_DEGREE = 3
N_SH = (MAX_SH_DEGREE + 1) ** 2  # 16
N_SPLIT = 2            # children per split gaussian
WEIGHTS_PRUNE = 1e-4   # prune where the accumulated blend weight is below

# Stage-1 raw parameter fields, in GaussianParams order.
FIELDS = ("xyz", "normal", "shs_dc", "shs_rest", "scaling", "rotation",
          "opacity")
# Stage-2 (PBR) fields, in GaussianParams order, and their per-point shapes.
PBR_SHAPES = {"base_color": (3,), "roughness": (1,), "incidents_dc": (1, 3),
              "incidents_rest": (N_SH - 1, 3), "visibility_dc": (1, 1),
              "visibility_rest": (15, 1)}
PBR_FIELDS = tuple(PBR_SHAPES)
# Densification statistics, in GaussianAux order (without `active`).
STATS = ("max_radii2d", "xyz_grad_accum", "normal_grad_accum", "denom",
         "weights_accum")


class GaussianModel(nn.Module):
    """Raw (pre-activation) parameters of P gaussians, the stage-1 fields
    and, when given (all or none), the PBR fields; and their densification
    statistics (buffers of [P], zero at construction)."""

    def __init__(self, xyz: torch.Tensor, normal: torch.Tensor,
                 shs_dc: torch.Tensor, shs_rest: torch.Tensor,
                 scaling: torch.Tensor, rotation: torch.Tensor,
                 opacity: torch.Tensor, **pbr: torch.Tensor):
        super().__init__()
        self.xyz = nn.Parameter(xyz)            # [P, 3]
        self.normal = nn.Parameter(normal)      # [P, 3]
        self.shs_dc = nn.Parameter(shs_dc)      # [P, 1, 3]
        self.shs_rest = nn.Parameter(shs_rest)  # [P, N_SH-1, 3]
        self.scaling = nn.Parameter(scaling)    # [P, 3] log-scale
        self.rotation = nn.Parameter(rotation)  # [P, 4] unnormalized quaternion
        self.opacity = nn.Parameter(opacity)    # [P, 1] logit
        if pbr and set(pbr) != set(PBR_FIELDS):
            raise ValueError(f"GaussianModel: PBR fields {sorted(pbr)}, "
                             f"expected all of {PBR_FIELDS} or none")
        for k in PBR_FIELDS if pbr else ():
            setattr(self, k, nn.Parameter(pbr[k]))   # logits / SH, see PBR_SHAPES
        self.reset_stats()

    @property
    def has_pbr(self) -> bool:
        return hasattr(self, "base_color")

    @property
    def fields(self) -> tuple[str, ...]:
        """The parameter fields present, in GaussianParams order."""
        return FIELDS + (PBR_FIELDS if self.has_pbr else ())

    def reset_stats(self) -> None:
        """Zero the densification statistics at the current size."""
        for k in STATS:
            self.register_buffer(k, torch.zeros(
                (self.num_points,), dtype=self.xyz.dtype,
                device=self.xyz.device))

    @classmethod
    def from_numpy(cls, d: Mapping[str, np.ndarray],
                   active: np.ndarray | None = None,
                   device: torch.device | str = "cuda") -> "GaussianModel":
        """Build from the JAX `GaussianParams` fields as numpy arrays, keeping
        only the rows where `active` is set (all rows when None), on
        `device` (the card unless the caller asks for the CPU). The PBR
        fields are read when `d` holds them with a row per point (a stage-1
        state's zero-width PBR leaves are not). The parameters are copies:
        training never writes into `d`."""
        keep = slice(None) if active is None else np.asarray(active, bool)
        rows = np.asarray(d["xyz"]).shape[0]
        fields = FIELDS + (PBR_FIELDS if all(
            k in d and np.asarray(d[k]).shape[:1] == (rows,)
            for k in PBR_FIELDS) else ())
        return cls(**{k: torch.tensor(np.asarray(d[k], np.float32)[keep],
                                      device=device) for k in fields})

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {k: getattr(self, k).detach().cpu().numpy() for k in self.fields}

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

    @property
    def get_base_color(self) -> torch.Tensor:
        return torch.sigmoid(self.base_color) * 0.77 + 0.03

    @property
    def get_roughness(self) -> torch.Tensor:
        return torch.sigmoid(self.roughness) * 0.9 + 0.09

    @property
    def get_incidents(self) -> torch.Tensor:
        """[P, N_SH, 3] local incident-light SH coefficients."""
        return torch.cat([self.incidents_dc, self.incidents_rest], dim=1)


def add_pbr_params(model: GaussianModel) -> GaussianModel:
    """Give a stage-1 model zero PBR parameters, in place (the stage-2
    bootstrap, gaussian_model.py:389-405); a model that has them is kept."""
    if not model.has_pbr:
        P, dev = model.num_points, model.xyz.device
        for k, shape in PBR_SHAPES.items():
            setattr(model, k, nn.Parameter(torch.zeros((P,) + shape,
                                                       device=dev)))
    return model


# ---------------------------------------------------------------------------
# Creation
# ---------------------------------------------------------------------------

def create_from_pcd(points: torch.Tensor, colors: torch.Tensor,
                    normals: torch.Tensor) -> GaussianModel:
    """Gaussians from a point cloud, on the points' device (gaussians.py:
    145-177): scale from the mean squared 3-NN distance, opacity 0.1,
    identity rotation, DC-only SH from the colours, zero normals replaced
    by +z."""
    n = points.shape[0]
    dev = points.device
    dist2 = torch.clamp(mean_sq_dist_to_3nn(points), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    rot = torch.zeros((n, 4), device=dev)
    rot[:, 0] = 1.0
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    normal = torch.where(
        torch.linalg.norm(normals, dim=-1, keepdim=True) < 1e-6, up, normals)
    return GaussianModel(
        xyz=points.clone(), normal=normal, shs_dc=rgb_to_sh(colors)[:, None, :],
        shs_rest=torch.zeros((n, N_SH - 1, 3), device=dev), scaling=scales,
        rotation=rot,
        opacity=inverse_sigmoid(torch.full((n, 1), 0.1, device=dev)))


# ---------------------------------------------------------------------------
# Composition (the relighting CLI's)
# ---------------------------------------------------------------------------

@torch.no_grad()
def set_transform(model: GaussianModel,
                  transform: torch.Tensor) -> GaussianModel:
    """A new model: `model` under the 4x4 affine `transform` (rotation,
    scale, translation; gaussian_model.py:88-112), on the model's device,
    with zero statistics. As the JAX package computes it: the scale is the
    norm of each row of the 3x3 block, the raw normals are rotated and not
    renormalized, and the rotation's quaternion multiplies the raw
    (unnormalized) quaternions."""
    transform = torch.as_tensor(transform, dtype=model.xyz.dtype,
                                device=model.xyz.device)
    A = transform[:3, :3]
    scale = torch.linalg.norm(A, dim=-1)            # per row
    rot = A / scale[:, None]
    xyz1 = torch.cat([model.xyz, torch.ones_like(model.xyz[:, :1])], dim=-1)
    values = {k: getattr(model, k).detach().clone() for k in model.fields}
    values.update(
        xyz=(xyz1 @ transform.T)[:, :3],
        scaling=torch.log(model.get_scaling * scale[None, :]),
        normal=model.normal @ rot.T,
        rotation=quaternion_multiply(rotmat_to_quaternion(rot)[None, :],
                                     model.rotation))
    return GaussianModel(**values)


@torch.no_grad()
def concatenate(models: Sequence[GaussianModel]) -> GaussianModel:
    """One model of the rows of `models` in turn (gaussian_model.py:344-356,
    `create_from_gaussians`), with zero statistics. Every model must hold
    the PBR fields."""
    lacking = [i for i, m in enumerate(models) if not m.has_pbr]
    if lacking:
        raise ValueError(f"concatenate: models {lacking} have no PBR fields")
    return GaussianModel(**{k: torch.cat([getattr(m, k).detach()
                                          for m in models])
                            for k in models[0].fields})


# ---------------------------------------------------------------------------
# Densification statistics
# ---------------------------------------------------------------------------

class StatContribs(NamedTuple):
    """Per-view densification-stat contributions."""
    weights: torch.Tensor          # [P]
    xyz_grad_norm: torch.Tensor    # [P]
    normal_grad_norm: torch.Tensor  # [P]
    denom: torch.Tensor            # [P]
    radii: torch.Tensor            # [P] f32 (max-combined)


def densification_contribs(mean2d_grad: torch.Tensor, normal_grad: torch.Tensor,
                           weights: torch.Tensor, radii: torch.Tensor,
                           image_wh: tuple[int, int]) -> StatContribs:
    """Per-view stat contributions (gaussians.py:242-268).

    mean2d_grad: [P, 2] d(loss)/d(pixel-space mean), scaled here by
    (0.5·W, 0.5·H) to the reference's NDC-gradient convention, for which
    densify_grad_threshold is tuned. normal_grad: [P, 3] d(loss)/d(raw
    normal); weights: [P] blend weights; radii: [P] (0 = not visible).
    """
    vis = (radii > 0).to(mean2d_grad.dtype)
    ndc = torch.tensor([0.5 * image_wh[0], 0.5 * image_wh[1]],
                       dtype=mean2d_grad.dtype, device=mean2d_grad.device)
    return StatContribs(
        weights=weights,
        xyz_grad_norm=vis * torch.linalg.norm(mean2d_grad * ndc, dim=-1),
        normal_grad_norm=vis * torch.linalg.norm(normal_grad, dim=-1),
        denom=vis,
        radii=vis * radii.to(mean2d_grad.dtype))


@torch.no_grad()
def add_densification_stats(model: GaussianModel, mean2d_grad: torch.Tensor,
                            normal_grad: torch.Tensor, weights: torch.Tensor,
                            radii: torch.Tensor,
                            image_wh: tuple[int, int]) -> None:
    """Accumulate one view's contributions into the model's statistics."""
    c = densification_contribs(mean2d_grad, normal_grad, weights, radii,
                               image_wh)
    model.weights_accum += c.weights
    model.xyz_grad_accum += c.xyz_grad_norm
    model.normal_grad_accum += c.normal_grad_norm
    model.denom += c.denom
    torch.maximum(model.max_radii2d, c.radii, out=model.max_radii2d)


# ---------------------------------------------------------------------------
# Densify / prune / reset: resizing with optimizer-state surgery
# ---------------------------------------------------------------------------

class DensifyStats(NamedTuple):
    n_cloned: int
    n_split: int
    n_pruned: int
    n_active: int


def _replace_parameters(model: GaussianModel, optimizer: torch.optim.Optimizer,
                        values: Mapping[str, torch.Tensor], moments) -> None:
    """Swap each field's nn.Parameter for one holding `values[field]` and
    re-key the optimizer: its group points at the new tensor, and the Adam
    moments become `moments(field, old_moment)`; the step is kept."""
    for group in optimizer.param_groups:
        name = group["name"]
        if name not in values:
            continue
        old = group["params"][0]
        new = nn.Parameter(values[name].contiguous())
        state = optimizer.state.pop(old, None)
        if state:
            for k in ("exp_avg", "exp_avg_sq"):
                state[k] = moments(name, state[k]).contiguous()
            optimizer.state[new] = state
        group["params"][0] = new
        setattr(model, name, new)


def densify_and_prune(model: GaussianModel, optimizer: torch.optim.Optimizer,
                      generator: torch.Generator, **thresholds) -> DensifyStats:
    """One adaptive-density step (gaussians.py:295-447). The split noise,
    standard normal [N_SPLIT, P, 3], is drawn from `generator` (on the
    model's device); see `densify_and_prune_with_noise` for the rest."""
    noise = torch.randn((N_SPLIT, model.num_points, 3), generator=generator,
                        device=model.xyz.device, dtype=model.xyz.dtype)
    return densify_and_prune_with_noise(model, optimizer, noise, **thresholds)


@torch.no_grad()
def densify_and_prune_with_noise(model: GaussianModel,
                                 optimizer: torch.optim.Optimizer,
                                 noise: torch.Tensor, *, grad_threshold: float,
                                 grad_normal_threshold: float,
                                 min_opacity: float, extent: float,
                                 max_screen_size: float, percent_dense: float
                                 ) -> DensifyStats:
    """Clone, split and prune in one pass, with the JAX package's semantics:

      * selection on the averaged stats: xyz_grad_accum / denom >=
        grad_threshold or normal_grad_accum / denom >= grad_normal_threshold;
        small selected points (max scale <= percent_dense·extent) are cloned,
        large ones split into n_split children drawn from their own
        covariance (noise [n_split, P, 3] standard normal), at scale /
        (0.8·n_split);
      * prune where opacity < min_opacity or weights_accum < WEIGHTS_PRUNE,
        or where the max scale exceeds 0.1·extent
        while `max_screen_size` is finite. The reference's screen-size term
        (max_radii2D > max_screen_size) never fires, because its
        densification_postfix zeroes max_radii2D just before, and is not
        applied (gaussians.py:323-334);
      * split child 0 takes its parent's row and its parent's other fields.

    Rows become [survivors, clones, split children 1..n_split-1]; surviving
    rows keep their Adam moments, split rows (child 0) and new rows get zero
    moments, every group keeps its step. The statistics are zeroed.
    """
    n_split = noise.shape[0]
    denom = model.denom
    denom_safe = torch.clamp(denom, min=1.0)
    grads = torch.where(denom > 0, model.xyz_grad_accum / denom_safe, 0.0)
    grads_n = torch.where(denom > 0, model.normal_grad_accum / denom_safe, 0.0)
    scales = model.get_scaling
    max_scale = scales.max(-1).values

    prune = ((model.get_opacity[:, 0] < min_opacity)
             | (model.weights_accum < WEIGHTS_PRUNE))
    if max_screen_size < float("inf"):
        prune |= max_scale > 0.1 * extent
    sel = ((grads >= grad_threshold) | (grads_n >= grad_normal_threshold)) & ~prune
    clone = sel & (max_scale <= percent_dense * extent)
    split = sel & (max_scale > percent_dense * extent)
    keep = ~prune

    rot = quaternion_to_rotmat(model.get_rotation)
    child_xyz = model.xyz[None] + torch.einsum("pij,npj->npi", rot,
                                               noise * scales[None])
    child_scaling = torch.log(torch.clamp(scales / (0.8 * n_split), min=1e-10))
    child = {"xyz": lambda j: child_xyz[j], "scaling": lambda j: child_scaling}

    values = {}
    for name in model.fields:
        base = getattr(model, name).detach()
        split_b = split.view(-1, *([1] * (base.dim() - 1)))
        survivors = (torch.where(split_b, child[name](0), base)
                     if name in child else base)
        rows = [survivors[keep], base[clone]]
        for j in range(1, n_split):
            rows.append((child[name](j) if name in child else base)[split])
        values[name] = torch.cat(rows)
    n_new = int(clone.sum()) + (n_split - 1) * int(split.sum())

    def moments(name, m):
        split_m = split.view(-1, *([1] * (m.dim() - 1)))
        m = torch.where(split_m, 0.0, m)[keep]
        return torch.cat([m, m.new_zeros((n_new,) + m.shape[1:])])

    stats = DensifyStats(n_cloned=int(clone.sum()), n_split=int(split.sum()),
                         n_pruned=int(prune.sum()),
                         n_active=int(keep.sum()) + n_new)
    _replace_parameters(model, optimizer, values, moments)
    model.reset_stats()
    return stats


@torch.no_grad()
def reset_opacity(model: GaussianModel,
                  optimizer: torch.optim.Optimizer) -> None:
    """Clamp opacities to <= 0.01 and zero their Adam moments
    (gaussians.py:480-487)."""
    new_op = inverse_sigmoid(torch.clamp(model.get_opacity, max=0.01))
    _replace_parameters(model, optimizer, {"opacity": new_op},
                        lambda name, m: torch.zeros_like(m))

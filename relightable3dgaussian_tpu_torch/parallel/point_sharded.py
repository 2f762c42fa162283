"""Point-sharded shading and ray-sharded visibility tracing over a group of
ranks (port of relightable3dgaussian_tpu/parallel/point_sharded.py).

The reference walks its P axis (10^5-10^6 gaussians × 24-384 incident
samples) in serial host chunks (gaussian_renderer/neilf.py:98-113,
scene/gaussian_model.py:322-336). Here, as in the JAX package, the axes are
split over the ranks:
  * the eval shading (`ops/shading_eval_cuda.py::rendering_equation_eval`:
    kernel K6 on the card) is independent per point: each rank shades its
    contiguous share of P under the whole env map;
  * the visibility trace splits the RAY axis (P·S rays): every rank holds
    the whole cluster structure and traces its share of the rays with
    `ops.ray_trace.trace_visibility` (kernel K3 on the card).
Every rank holds the whole inputs and gets the whole outputs: the shares
are gathered by an all_reduce of a zero-filled full buffer (gloo has no
all_gather of CUDA tensors; x + 0 is x). The gather is not differentiable:
these are eval paths. Every rank of the group must make the same calls.

The JAX tracer's caps, escalation rounds and overflow counts exist because
its TPU pass is capped; K3 is exact, so every ray is traced once, the
overflow is zero and `last_stats` reports no round.
"""
from __future__ import annotations

import math

import torch

from ..ops.ray_trace import GaussianBVH, trace_visibility
from ..ops.shading_eval_cuda import EXTRA_KEYS, rendering_equation_eval
from .data_parallel import Group, all_reduce_


def _share(n: int, group: Group) -> slice:
    """This rank's contiguous rows of n (n divisible by the group's size)."""
    if n % group.size:
        raise ValueError(f"{n} rows over {group.size} ranks: pad to a "
                         "multiple of the group's size")
    k = n // group.size
    return slice(group.rank * k, (group.rank + 1) * k)


def shard_points(tree, group: Group):
    """This rank's share of the leading (P) axis of a tensor, or of every
    tensor of a tuple or list."""
    if isinstance(tree, torch.Tensor):
        return tree[_share(tree.shape[0], group)]
    return type(tree)(shard_points(v, group) for v in tree)


def _gather(parts: list[torch.Tensor], n: int, group: Group
            ) -> list[torch.Tensor]:
    """The full [n, ...] tensors of every rank's shares `parts`, in one
    collective."""
    rows = _share(n, group)
    widths = [math.prod(p.shape[1:]) for p in parts]
    full = parts[0].new_zeros((n, sum(widths)))
    full[rows] = torch.cat([p.reshape(p.shape[0], -1) for p in parts], dim=1)
    all_reduce_(full, group)
    return [f.reshape((n,) + p.shape[1:])
            for f, p in zip(full.split(widths, dim=1), parts)]


def make_sharded_shading(group: Group, full_extras: bool = False):
    """Point-sharded rendering equation (the reference's eval shading chunk
    loop, neilf.py:98-113, split over the ranks).

    Returns fn(base_color, roughness, normals, viewdirs, incidents_shs, env,
    visibility, incident_dirs, incident_areas) with every per-point
    argument whole on every rank, P divisible by the group's size
    (`fn.group` is attached for callers that pad). Without `full_extras` it
    returns (pbr, diffuse_light); with it, (pbr, extras), the per-sample
    extras reduced to their sample means (`EXTRA_KEYS`, the visibility's
    among them): what the stage-2 eval splats. A rank shades its share in
    one call of `rendering_equation_eval` (one K6 launch on the card).
    """
    def fn(base_color, roughness, normals, viewdirs, incidents, env, vis,
           inc_dirs, inc_areas):
        P = base_color.shape[0]
        pbr, extras = rendering_equation_eval(
            *shard_points((base_color, roughness, normals, viewdirs,
                           incidents), group), env,
            *shard_points((vis, inc_dirs, inc_areas), group))
        keys = EXTRA_KEYS if full_extras else ("diffuse_light",)
        pbr, *parts = _gather([pbr, *(extras[k] for k in keys)], P, group)
        if not full_extras:
            return pbr, parts[0]
        return pbr, dict(zip(keys, parts))

    fn.group = group
    return fn


def make_sharded_trace(group: Group):
    """Ray-sharded visibility tracing.

    Returns fn(bvh, rays_o, rays_d, with_overflow=False, max_clusters=None,
    max_supers=None) → visibility [R, 1] on every rank, each rank tracing
    its contiguous share of the R rays (R divisible by the group's size)
    through the whole cluster structure; with `with_overflow`, also the
    overflow [R] (int32 zeros: K3 drops no candidate). The caps are the
    JAX signature's and have no effect; `fn.last_stats` is
    {"rounds": 0, "retraced_rays": 0} after each call.
    """
    def fn(bvh: GaussianBVH, rays_o: torch.Tensor, rays_d: torch.Tensor,
           with_overflow: bool = False, max_clusters: int | None = None,
           max_supers: int | None = None):
        del max_clusters, max_supers
        R = rays_o.shape[0]
        mine = trace_visibility(bvh, *shard_points((rays_o, rays_d), group))
        (vis,) = _gather([mine], R, group)
        fn.last_stats = {"rounds": 0, "retraced_rays": 0}
        if with_overflow:
            return vis, torch.zeros((R,), dtype=torch.int32,
                                    device=vis.device)
        return vis

    fn.group = group
    fn.last_stats = {"rounds": 0, "retraced_rays": 0}
    return fn

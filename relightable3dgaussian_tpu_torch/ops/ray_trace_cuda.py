"""Kernel K3: ray-traced transmittance on the card.

K3 (`csrc/ray_trace.cu`) replaces the TPU kernel
`relightable3dgaussian_tpu/ops/ray_trace.py::_trace_eval_kernel`. It applies
the rule of ops/ray_trace.py to every ray in one launch; `trace_k3` takes the
BVH and rays already moved to their offset origins, sorts them into
`ops/ray_trace.py::coherent_order` (the kernel reads them through the
permutation and writes each T in place), and returns T [R] in the rays'
order (any value below 0.9 stands for "blocked"). A ray's T does not depend
on the order. `ops/ray_trace.py::trace_visibility` calls it for CUDA
tensors and applies the T >= 0.9 rule. The tracer's counter `k3.launches`
counts its launches.
"""
from __future__ import annotations

import torch

from . import _build
from .ray_trace import (CLUSTER_SIZE, RECORD, SUPER_SIZE, GaussianBVH,
                        coherent_order)

KERNEL = "ray_trace"
_K3 = _build.Entry(KERNEL, "r3dg_trace", "pppppppp iii p", "K3",
                   ("k3.launches",))


def trace_k3(bvh: GaussianBVH, rays_o: torch.Tensor, rays_d: torch.Tensor,
             sort: bool = True) -> torch.Tensor:
    """Launch K3 on CUDA tensors: rays [R, 3] starting at their offset
    origins → transmittance [R]. The rays are traced in coherent order, or
    with `sort=False` in the order given."""
    device = rays_o.device
    R = rays_o.shape[0]
    C = bvh.cluster_lo.shape[0]
    n_super = bvh.super_lo.shape[0]
    expect = {"records": (bvh.records, (C * CLUSTER_SIZE, RECORD)),
              "cluster_lo": (bvh.cluster_lo, (C, 3)),
              "cluster_hi": (bvh.cluster_hi, (C, 3)),
              "super_lo": (bvh.super_lo, (-(-C // SUPER_SIZE), 3)),
              "super_hi": (bvh.super_hi, (n_super, 3)),
              "rays_o": (rays_o, (R, 3)), "rays_d": (rays_d, (R, 3))}
    _build.check_tensors("K3", device, expect)
    order = (coherent_order(bvh, rays_o, rays_d).to(torch.int32)
             if sort and R > 1 and C > 0 else None)
    T = torch.empty((R,), dtype=torch.float32, device=device)
    _K3(device, bvh.records, bvh.cluster_lo, bvh.cluster_hi, bvh.super_lo,
        bvh.super_hi, rays_o, rays_d, order, C, n_super, R, T)
    return T

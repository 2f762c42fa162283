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

import ctypes

import torch

from ..utils import trace
from . import _build
from .ray_trace import (CLUSTER_SIZE, RECORD, SUPER_SIZE, GaussianBVH,
                        coherent_order)

KERNEL = "ray_trace"


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
    for name, (t, shape) in expect.items():
        if (t.device != device or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"K3 {name}: got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected float32 {shape} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"K3 {name}: not contiguous")
    lib = _build.load_library(KERNEL)
    if lib.r3dg_trace.argtypes is None:
        lib.r3dg_trace.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                                   + [ctypes.c_void_p] * 2)
        lib.r3dg_trace.restype = ctypes.c_int
    order = (coherent_order(bvh, rays_o, rays_d).to(torch.int32)
             if sort and R > 1 and C > 0 else None)
    T = torch.empty((R,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.r3dg_trace(
            bvh.records.data_ptr(), bvh.cluster_lo.data_ptr(),
            bvh.cluster_hi.data_ptr(), bvh.super_lo.data_ptr(),
            bvh.super_hi.data_ptr(), rays_o.data_ptr(), rays_d.data_ptr(),
            order.data_ptr() if order is not None else None,
            C, n_super, R, T.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError_t {rc}")
    trace.count("k3.launches")
    return T

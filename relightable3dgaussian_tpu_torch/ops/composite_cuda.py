"""Kernel K1: the forward tile compositor on the card.

K1 replaces the TPU kernel
`relightable3dgaussian_tpu/ops/composite_pallas.py::_kernel`.

`composite` takes the same inputs as the plain compositor
(ops/composite.py::composite) and returns the same `CompositeOut`:
  * CPU tensors → the plain PyTorch version;
  * CUDA tensors → the hand-written kernel `csrc/composite_fwd.cu`, or an
    exception. A build or launch error is raised, never answered with the
    plain version.
The kernel has no backward yet: CUDA inputs that require grad raise
NotImplementedError. `LAUNCHES` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .composite import CompositeOut, composite as composite_plain
from .config import RasterConfig
from .tiles import Binning

KERNEL = "composite_fwd"
MAX_ATTRS = 32     # csrc/composite_fwd.cu kMaxA
LAUNCHES = 0       # launches of the kernel since import (or the last reset)


def _library() -> ctypes.CDLL:
    lib = _build.load_library(KERNEL)
    fn = lib.r3dg_composite_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return lib


def composite(binning: Binning, mean2d: torch.Tensor, conic: torch.Tensor,
              opacity: torch.Tensor, attrs: torch.Tensor,
              cfg: RasterConfig) -> CompositeOut:
    """Tile compositing: the plain version on CPU tensors, K1 on CUDA tensors."""
    tensors = (binning.sorted_ids, binning.tile_start, binning.tile_end,
               mean2d, conic, opacity, attrs)
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return composite_plain(binning, mean2d, conic, opacity, attrs, cfg)
    if devices != {"cuda"}:
        raise ValueError(f"composite: inputs on {sorted(devices)}; "
                         "expected all on CPU or all on CUDA")
    return composite_k1(binning, mean2d, conic, opacity, attrs, cfg)


def composite_k1(binning: Binning, mean2d: torch.Tensor, conic: torch.Tensor,
                 opacity: torch.Tensor, attrs: torch.Tensor,
                 cfg: RasterConfig) -> CompositeOut:
    """Launch K1 on CUDA tensors (forward only)."""
    global LAUNCHES
    if any(t.requires_grad for t in (mean2d, conic, opacity, attrs)):
        raise NotImplementedError("backward kernel K2: later PR")
    if cfg.tile != 16:
        raise ValueError(f"K1 takes 16x16 tiles, got tile={cfg.tile}")
    P, A = attrs.shape
    if not 1 <= A <= MAX_ATTRS:
        raise ValueError(f"K1 takes 1..{MAX_ATTRS} attribute channels, got {A}")
    expect = {"mean2d": (mean2d, (P, 2), torch.float32),
              "conic": (conic, (P, 3), torch.float32),
              "opacity": (opacity, (P,), torch.float32),
              "attrs": (attrs, (P, A), torch.float32),
              "sorted_ids": (binning.sorted_ids, (binning.num_rendered,),
                             torch.int32),
              "tile_start": (binning.tile_start, (cfg.num_tiles,), torch.int32),
              "tile_end": (binning.tile_end, (cfg.num_tiles,), torch.int32)}
    device = attrs.device
    for name, (t, shape, dtype) in expect.items():
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"K1 {name}: got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected {dtype} {shape} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"K1 {name}: not contiguous")

    lib = _library()
    tt = cfg.tile * cfg.tile
    image = torch.empty((cfg.num_tiles, tt, A), dtype=torch.float32,
                        device=device)
    n_contrib = torch.empty((cfg.num_tiles, tt), dtype=torch.int32,
                            device=device)
    weights = torch.zeros((P,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.r3dg_composite_fwd(
            binning.tile_start.data_ptr(), binning.tile_end.data_ptr(),
            binning.sorted_ids.data_ptr(), mean2d.data_ptr(),
            conic.data_ptr(), opacity.data_ptr(), attrs.data_ptr(),
            cfg.num_tiles, cfg.tiles_x, A, image.data_ptr(),
            n_contrib.data_ptr(),
            weights.data_ptr() if cfg.compute_weights else None, stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return CompositeOut(image=image, weights=weights, n_contrib=n_contrib)

"""The env light's lookup on the card: a gather forward and a backward that
sums the map's gradient per block in shared memory (`csrc/env_lookup.cu`).

It replaces no TPU kernel: the JAX package leaves the lookup to XLA. The
plain version is `models/lights.py::equirect_query_plain` (F.grid_sample),
which CPU tensors take; `equirect_query` sends CUDA tensors here, where
`env_lookup` launches the kernels or raises. Nothing falls back.

`env_lookup(envmap, dirs, transform)` is a `torch.autograd.Function` whose
backward gives the map alone its gradient: directions and a transform that
need one are refused. The backward's branch follows the map's size
(`private_branch`): warp-private copies of the gradient in shared memory,
summed per block and then over the blocks in a fixed order (bitwise the
same from run to run), where they fit; global atomics beyond.

Counters: `launches` and `bwd_launches` (plain integers here), and the
tracer's `env.lookup_launches`, `env.lookup_bwd_launches` and
`env.bwd_private` (backward launches of the private branch).
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from . import _build

KERNEL = "env_lookup"
THREADS = 256                     # csrc/env_lookup.cu kThreads
WARPS = THREADS // 32             # kWarps: private copies a block
PRIVATE_BYTES = 192 * 1024        # kPrivateBytes: the copies' budget
SMEM_PER_SM = 228 * 1024          # an H100 SM's shared memory
SMEM_RESERVED = 1024              # what the card keeps of it per block
BLOCKS_PER_SM = 2048 // THREADS   # threads an SM holds

launches = 0        # forward launches
bwd_launches = 0    # backward launches (each its kernel and, private, its reduce)


def private_branch(H: int, W: int) -> bool:
    """Whether the backward of an [H, W, 3] map keeps its gradient in
    shared memory: WARPS copies of H W 3 floats within PRIVATE_BYTES
    (H W <= 2048)."""
    return WARPS * 3 * H * W * 4 <= PRIVATE_BYTES


def backward_blocks(n: int, H: int, W: int, sms: int) -> int:
    """The backward's grid for n samples on a card of `sms` SMs: as many
    blocks as the card holds at once (by the private copies' shared memory),
    never more than the samples fill. Fixed by n, the map and the card, so
    the private branch's sums fall in one order every run."""
    per_sm = BLOCKS_PER_SM
    if private_branch(H, W):
        smem = WARPS * 3 * H * W * 4 + SMEM_RESERVED
        per_sm = max(1, min(per_sm, SMEM_PER_SM // smem))
    return max(1, min(-(-n // THREADS), sms * per_sm))


def forward_blocks(n: int, sms: int) -> int:
    """The forward's grid: a thread a sample, at most 16 blocks an SM
    (grid-stride beyond)."""
    return max(1, min(-(-n // THREADS), 16 * sms))


def check_inputs(envmap: torch.Tensor, dirs: torch.Tensor,
                 transform: torch.Tensor | None) -> None:
    """Raises unless the map is [H, W, 3], the directions [N, 3] and the
    transform None or [3, 3], each float32 and contiguous, neither the
    directions nor the transform needs a gradient, and all lie on one CUDA
    device: the only check before a launch."""
    expect = {"envmap": (envmap, 3, "[H, W, 3]"), "dirs": (dirs, 2, "[N, 3]")}
    if transform is not None:
        expect["transform"] = (transform, 2, "[3, 3]")
    for name, (t, ndim, want) in expect.items():
        if (t.dtype != torch.float32 or t.dim() != ndim or t.shape[-1] != 3
                or (name == "transform" and t.shape[0] != 3)):
            raise ValueError(f"env lookup {name}: got {t.dtype} "
                             f"{tuple(t.shape)}, expected float32 {want}")
        if not t.is_contiguous():
            raise ValueError(f"env lookup {name}: not contiguous")
        if name != "envmap" and t.requires_grad:
            raise ValueError(f"env lookup {name}: requires grad; the kernel "
                             "gives the map alone a gradient")
    for name, (t, _, _) in expect.items():
        if t.device.type != "cuda" or t.device != envmap.device:
            raise ValueError(f"env lookup {name}: on {t.device}, expected "
                             f"the map's CUDA device ({envmap.device})")


class EnvLookup(torch.autograd.Function):
    """(envmap [H, W, 3], dirs [N, 3], transform [3, 3] or None) → [N, 3]
    radiance; the backward gives the map's gradient. Saves the directions
    (a view of the caller's tensor) and the transform, nothing else."""

    @staticmethod
    def forward(ctx, envmap, dirs, transform):
        ctx.save_for_backward(dirs, transform)
        ctx.map_hw = tuple(envmap.shape[:2])
        return lookup_fwd(envmap, dirs, transform)

    @staticmethod
    def backward(ctx, g_out):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        dirs, transform = ctx.saved_tensors
        return lookup_bwd(dirs, transform, g_out.contiguous(),
                          *ctx.map_hw), None, None


def env_lookup(envmap: torch.Tensor, dirs: torch.Tensor,
               transform: torch.Tensor | None = None) -> torch.Tensor:
    """The lookup of directions [N, 3] in the map [H, W, 3] on the card:
    contiguous [N, 3], differentiable in the map."""
    check_inputs(envmap, dirs, transform)
    return EnvLookup.apply(envmap, dirs, transform)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def lookup_fwd(envmap, dirs, transform) -> torch.Tensor:
    """The forward kernel: [N, 3]."""
    global launches
    n = dirs.shape[0]
    H, W = envmap.shape[:2]
    out = torch.empty((n, 3), dtype=torch.float32, device=dirs.device)
    if n == 0:
        return out
    fn = _build.load_library(KERNEL).r3dg_env_lookup_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    with torch.cuda.device(dirs.device):
        rc = fn(envmap.data_ptr(), dirs.data_ptr(), _ptr(transform), n, H, W,
                forward_blocks(n, _sms(dirs.device)), out.data_ptr(),
                _stream(dirs.device))
    if rc != 0:
        raise RuntimeError(f"env lookup forward launch failed: cudaError_t {rc}")
    launches += 1
    trace.count("env.lookup_launches")
    return out


def lookup_bwd(dirs, transform, g_out, H: int, W: int) -> torch.Tensor:
    """The backward kernels: the map's gradient [H, W, 3]."""
    global bwd_launches
    n = dirs.shape[0]
    if g_out.shape != (n, 3) or g_out.dtype != torch.float32:
        raise ValueError(f"env lookup gradient: got {g_out.dtype} "
                         f"{tuple(g_out.shape)}, expected float32 ({n}, 3)")
    priv = private_branch(H, W)
    grad = (torch.empty if priv else torch.zeros)(
        (H, W, 3), dtype=torch.float32, device=dirs.device)
    if n == 0:
        return grad.zero_()
    blocks = backward_blocks(n, H, W, _sms(dirs.device))
    partial = (torch.empty((blocks, 3 * H * W), dtype=torch.float32,
                           device=dirs.device) if priv else None)
    fn = _build.load_library(KERNEL).r3dg_env_lookup_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    with torch.cuda.device(dirs.device):
        rc = fn(dirs.data_ptr(), _ptr(transform), g_out.data_ptr(), n, H, W,
                blocks, _ptr(partial), grad.data_ptr(), _stream(dirs.device))
    if rc != 0:
        raise RuntimeError(f"env lookup backward launch failed: cudaError_t {rc}")
    bwd_launches += 1
    trace.count("env.lookup_bwd_launches")
    if priv:
        trace.count("env.bwd_private")
    return grad

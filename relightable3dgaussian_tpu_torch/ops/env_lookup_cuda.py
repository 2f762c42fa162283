"""The env light's lookup: `equirect_query`, the radiance of an equirect map
for directions, and on the card its kernels, a gather forward and a
backward that sums the map's gradient per block in shared memory
(`csrc/env_lookup.cu`).

It replaces no TPU kernel: the JAX package leaves the lookup to XLA. The
plain version is `equirect_query_plain` (F.grid_sample), which CPU tensors
take; `equirect_query` sends CUDA tensors to `env_lookup`, which launches
the kernels or raises. Nothing falls back. The light models
(`models/lights.py`) query their maps through `equirect_query`.

`env_lookup(envmap, dirs, transform)` is a `torch.autograd.Function` whose
backward gives the map alone its gradient: directions and a transform that
need one are refused. The backward's branch follows the map's size
(`private_branch`): warp-private copies of the gradient in shared memory,
summed per block and then over the blocks in a fixed order (bitwise the
same from run to run), where they fit; global atomics beyond.

The tracer's counters: `env.lookup_launches`, `env.lookup_bwd_launches` and
`env.bwd_private` (backward launches of the private branch).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..utils import trace
from . import _build

KERNEL = "env_lookup"
THREADS = 256                     # csrc/env_lookup.cu kThreads
WARPS = THREADS // 32             # kWarps: private copies a block
PRIVATE_BYTES = 192 * 1024        # kPrivateBytes: the copies' budget
SMEM_PER_SM = 228 * 1024          # an H100 SM's shared memory
SMEM_RESERVED = 1024              # what the card keeps of it per block
BLOCKS_PER_SM = 2048 // THREADS   # threads an SM holds
_FWD = _build.Entry(KERNEL, "r3dg_env_lookup_fwd", "ppp q iii p",
                    "env lookup forward", ("env.lookup_launches",))
# a launch: the kernel and, on the private branch, its reduce
_BWD = _build.Entry(KERNEL, "r3dg_env_lookup_bwd", "ppp q iii pp",
                    "env lookup backward", ("env.lookup_bwd_launches",))


def grid_sample_bilinear(img: torch.Tensor, gx: torch.Tensor,
                         gy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img [H, W, C] at normalized coordinates gx, gy
    (same shape, in [-1, 1]) → [..., C]."""
    grid = torch.stack([gx, gy], dim=-1).reshape(1, 1, -1, 2)
    out = F.grid_sample(img.permute(2, 0, 1)[None], grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[0, :, 0].T.reshape(*gx.shape, img.shape[-1])


def equirect_query_plain(envmap: torch.Tensor, dirs: torch.Tensor,
                         transform: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Radiance of the equirect map [H, W, 3] for unit directions [..., 3]:
    φ = arccos(clip z) − 1e-6 down the rows, θ = atan2(y, x) across the
    columns (gy = 2φ/π − 1, gx = −θ/π), through `grid_sample_bilinear`.
    The plain version, on any device and dtype."""
    shape = dirs.shape
    d = dirs.reshape(-1, 3)
    if transform is not None:
        d = d @ transform.T
    phi = torch.arccos(torch.clamp(d[:, 2], -1.0, 1.0)) - 1e-6
    theta = torch.atan2(d[:, 1], d[:, 0])
    gy = (phi / math.pi) * 2.0 - 1.0
    gx = -theta / math.pi
    return grid_sample_bilinear(envmap, gx, gy).reshape(shape)


def equirect_query(envmap: torch.Tensor, dirs: torch.Tensor,
                   transform: torch.Tensor | None = None) -> torch.Tensor:
    """`equirect_query_plain`'s radiance: the plain version on CPU tensors;
    on CUDA tensors the kernel pair (`env_lookup`: float32, a gradient for
    the map alone), or an exception."""
    tensors = (envmap, dirs) + (() if transform is None else (transform,))
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return equirect_query_plain(envmap, dirs, transform)
    if devices != {"cuda"}:
        raise ValueError(f"equirect_query: inputs on {sorted(devices)}; "
                         "expected all on CPU or all on CUDA")
    out = env_lookup(envmap.contiguous(), dirs.reshape(-1, 3).contiguous(),
                     transform)
    return out.reshape(dirs.shape)


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
    transform None or [3, 3], each float32 and contiguous on the map's
    device, which is a CUDA device, and neither the directions nor the
    transform needs a gradient: the only check before a launch."""
    expect = {"envmap": (envmap, (*envmap.shape[:2], 3)),
              "dirs": (dirs, (*dirs.shape[:1], 3))}
    if transform is not None:
        expect["transform"] = (transform, (3, 3))
    _build.check_tensors("env lookup", envmap.device, expect)
    for name, t in (("dirs", dirs), ("transform", transform)):
        if t is not None and t.requires_grad:
            raise ValueError(f"env lookup {name}: requires grad; the kernel "
                             "gives the map alone a gradient")
    if envmap.device.type != "cuda":
        raise ValueError(f"env lookup envmap: on {envmap.device}, expected "
                         "the map's CUDA device")


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


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def lookup_fwd(envmap, dirs, transform) -> torch.Tensor:
    """The forward kernel: [N, 3]."""
    n = dirs.shape[0]
    H, W = envmap.shape[:2]
    out = torch.empty((n, 3), dtype=torch.float32, device=dirs.device)
    if n == 0:
        return out
    _FWD(dirs.device, envmap, dirs, transform, n, H, W,
         forward_blocks(n, _sms(dirs.device)), out)
    return out


def lookup_bwd(dirs, transform, g_out, H: int, W: int) -> torch.Tensor:
    """The backward kernels: the map's gradient [H, W, 3]."""
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
    _BWD(dirs.device, dirs, transform, g_out, n, H, W, blocks, partial, grad)
    if priv:
        trace.count("env.bwd_private")
    return grad

"""Kernels K1, K2 and K5: the tile compositor and its backward on the card.

K1 (`csrc/composite_fwd.cu`) replaces the TPU kernel
`relightable3dgaussian_tpu/ops/composite_pallas.py::_kernel`; K2
(`csrc/composite_bwd.cu`) replaces
`relightable3dgaussian_tpu/ops/composite_pallas_bwd.py::_bwd_kernel_single`;
K5 (`csrc/composite_bwd_two_walk.cu`) replaces its `_bwd_kernel`, the
two-walk backward the JAX package runs under `R3DG_BWD_TWO_WALK=1`.

`composite` takes the same inputs as the plain compositor
(ops/composite.py::composite) and returns the same `CompositeOut`:
  * CPU tensors → the plain PyTorch version, differentiable by autograd;
  * CUDA tensors → `CompositeFunction`, a `torch.autograd.Function` whose
    forward is K1 and whose backward is K2, or K5 where the environment sets
    `R3DG_BWD_TWO_WALK=1` (read at each backward, as the JAX package reads
    it), or an exception. A build or launch error is raised, never answered
    with the plain version.
`image` and `weights` are differentiable; `n_contrib` is not. The tracer's
counters `k1.launches`, `k2.launches` and `k5.launches` count K1's, K2's
and K5's launches (`utils/trace.py`). The
plain version of both backward kernels is `ops/composite.py::
composite_backward`: they compute the same function.

`blend_decisions` is a check, never on a main path: K1's blend decisions at
a list of pixels (`csrc/composite_decisions.cu`, K1's alpha step and walk),
which `ops/composite.py::replay_backward` turns into the exact VJP that K2
is held to where K1 and the plain compositor blend other pairs.
"""
from __future__ import annotations

import os

import torch

from . import _build
from .composite import CompositeOut, Decisions, WalkState
from .composite import blend_decisions as blend_decisions_plain
from .composite import composite as composite_plain
from .config import RasterConfig
from .tiles import Binning

KERNEL = "composite_fwd"
BWD_KERNEL = "composite_bwd"
TWO_WALK_KERNEL = "composite_bwd_two_walk"
DECISIONS_KERNEL = "composite_decisions"
MAX_ATTRS = 32     # csrc/composite_*.cu kMaxA
# The attribute widths K1, K2 and K5 build apart, with their accumulators in
# registers at that width (the `case`s of the dispatch in each source): the
# main paths' 9 (stage 1), 8 (stage-2 train under STAGE2_NERF_SYNTHETIC) and,
# for K1, 32 (stage-2 eval). Other widths up to MAX_ATTRS take the general
# build.
SPECIALISED_WIDTHS = {KERNEL: (9, 8, 32), BWD_KERNEL: (9, 8),
                      TWO_WALK_KERNEL: (9, 8)}
_K1 = _build.Entry(KERNEL, "r3dg_composite_fwd", "ppppppp iii ppppp", "K1",
                   ("k1.launches",))
_K2 = _build.Entry(BWD_KERNEL, "r3dg_composite_bwd", "pppppppppp iii pppp",
                   "K2", ("k2.launches",))
_K5 = _build.Entry(TWO_WALK_KERNEL, "r3dg_composite_bwd_two_walk",
                   "ppppppppp iii ppppp", "K5", ("k5.launches",))
_DECISIONS = _build.Entry(DECISIONS_KERNEL, "r3dg_composite_decisions",
                          "ppppppp iii pppp", "decisions")


def composite(binning: Binning, mean2d: torch.Tensor, conic: torch.Tensor,
              opacity: torch.Tensor, attrs: torch.Tensor,
              cfg: RasterConfig) -> CompositeOut:
    """Tile compositing: the plain version on CPU tensors, K1 (forward) and
    K2 (backward) on CUDA tensors."""
    tensors = (binning.sorted_ids, binning.tile_start, binning.tile_end,
               mean2d, conic, opacity, attrs)
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return composite_plain(binning, mean2d, conic, opacity, attrs, cfg)
    if devices != {"cuda"}:
        raise ValueError(f"composite: inputs on {sorted(devices)}; "
                         "expected all on CPU or all on CUDA")
    image, weights, n_contrib = CompositeFunction.apply(
        mean2d, conic, opacity, attrs, binning, cfg)
    return CompositeOut(image=image, weights=weights, n_contrib=n_contrib)


def two_walk_selected() -> bool:
    """The JAX package's switch (ops/composite_pallas_bwd.py:491-492)."""
    return os.environ.get("R3DG_BWD_TWO_WALK") == "1"


class CompositeFunction(torch.autograd.Function):
    """(mean2d, conic, opacity, attrs) → (image, weights, n_contrib) by K1;
    the backward is K2, started from K1's walk state, or K5 under
    `R3DG_BWD_TWO_WALK=1`."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, attrs, binning: Binning,
                cfg: RasterConfig):
        out, walk = composite_k1(binning, mean2d, conic, opacity, attrs, cfg)
        ctx.binning, ctx.cfg = binning, cfg
        ctx.save_for_backward(mean2d, conic, opacity, attrs, *walk)
        ctx.mark_non_differentiable(out.n_contrib)
        # An output the loss does not read gets a None cotangent, not zeros.
        ctx.set_materialize_grads(False)
        return out.image, out.weights, out.n_contrib

    @staticmethod
    def backward(ctx, g_image, g_weights, _g_n_contrib):
        mean2d, conic, opacity, attrs, final_T, stop = ctx.saved_tensors
        cfg = ctx.cfg
        # Without compute_weights K1 returns zeros that no input reaches.
        if not cfg.compute_weights:
            g_weights = None
        if g_image is None and g_weights is None:
            return (None,) * 6
        if g_image is None:
            g_image = torch.zeros((cfg.num_tiles, cfg.tile * cfg.tile,
                                   attrs.shape[1]), device=attrs.device)
        if two_walk_selected():
            grads = composite_k5(ctx.binning, mean2d, conic, opacity, attrs,
                                 g_image.contiguous(), g_weights, cfg)
        else:
            grads = composite_k2(ctx.binning, mean2d, conic, opacity, attrs,
                                 WalkState(final_T, stop),
                                 g_image.contiguous(), g_weights, cfg)
        return (*grads, None, None)


def _inputs(kernel: str, binning: Binning, mean2d, conic, opacity, attrs,
            cfg: RasterConfig) -> dict:
    """The shapes both kernels take, checked; returns the expectation dict."""
    if cfg.tile != 16:
        raise ValueError(f"{kernel} takes 16x16 tiles, got tile={cfg.tile}")
    P, A = attrs.shape
    if not 1 <= A <= MAX_ATTRS:
        raise ValueError(f"{kernel} takes 1..{MAX_ATTRS} attribute channels, "
                         f"got {A}")
    n_tiles = cfg.num_tiles
    return {"mean2d": (mean2d, (P, 2)), "conic": (conic, (P, 3)),
            "opacity": (opacity, (P,)), "attrs": (attrs, (P, A)),
            "sorted_ids": (binning.sorted_ids, (binning.num_rendered,),
                           torch.int32),
            "tile_start": (binning.tile_start, (n_tiles,), torch.int32),
            "tile_end": (binning.tile_end, (n_tiles,), torch.int32)}


def composite_k1(binning: Binning, mean2d: torch.Tensor, conic: torch.Tensor,
                 opacity: torch.Tensor, attrs: torch.Tensor,
                 cfg: RasterConfig) -> tuple[CompositeOut, WalkState]:
    """Launch K1 on CUDA tensors: the forward outputs and the walk state."""
    expect = _inputs("K1", binning, mean2d, conic, opacity, attrs, cfg)
    device = attrs.device
    _build.check_tensors("K1", device, expect)
    P, A = attrs.shape
    n_tiles, tt = cfg.num_tiles, cfg.tile * cfg.tile
    image = torch.empty((n_tiles, tt, A), dtype=torch.float32, device=device)
    n_contrib = torch.empty((n_tiles, tt), dtype=torch.int32, device=device)
    weights = torch.zeros((P,), dtype=torch.float32, device=device)
    final_T = torch.empty((n_tiles, tt), dtype=torch.float32, device=device)
    stop = torch.empty((n_tiles, tt), dtype=torch.int32, device=device)
    _K1(device, binning.tile_start, binning.tile_end, binning.sorted_ids,
        mean2d, conic, opacity, attrs, n_tiles, cfg.tiles_x, A, image,
        n_contrib, weights if cfg.compute_weights else None, final_T, stop)
    return (CompositeOut(image=image, weights=weights, n_contrib=n_contrib),
            WalkState(final_T=final_T, stop=stop))


def composite_k2(binning: Binning, mean2d: torch.Tensor, conic: torch.Tensor,
                 opacity: torch.Tensor, attrs: torch.Tensor, walk: WalkState,
                 g_image: torch.Tensor, g_weights: torch.Tensor | None,
                 cfg: RasterConfig):
    """Launch K2 on CUDA tensors: (g_mean2d, g_conic, g_opacity, g_attrs)
    for the cotangents g_image [num_tiles, 256, A] and g_weights [P] (None
    means zeros), from K1's walk state on the same inputs."""
    expect = _inputs("K2", binning, mean2d, conic, opacity, attrs, cfg)
    P, A = attrs.shape
    n_tiles, tt = cfg.num_tiles, cfg.tile * cfg.tile
    expect.update({
        "final_T": (walk.final_T, (n_tiles, tt)),
        "stop": (walk.stop, (n_tiles, tt), torch.int32),
        "g_image": (g_image, (n_tiles, tt, A))})
    if g_weights is not None:
        expect["g_weights"] = (g_weights, (P,))
    device = attrs.device
    _build.check_tensors("K2", device, expect)
    g_mean2d = torch.zeros((P, 2), dtype=torch.float32, device=device)
    g_conic = torch.zeros((P, 3), dtype=torch.float32, device=device)
    g_opacity = torch.zeros((P,), dtype=torch.float32, device=device)
    g_attrs = torch.zeros((P, A), dtype=torch.float32, device=device)
    _K2(device, binning.tile_start, binning.sorted_ids, mean2d, conic,
        opacity, attrs, walk.final_T, walk.stop, g_image, g_weights,
        n_tiles, cfg.tiles_x, A, g_mean2d, g_conic, g_opacity, g_attrs)
    return g_mean2d, g_conic, g_opacity, g_attrs


def composite_k5(binning: Binning, mean2d: torch.Tensor, conic: torch.Tensor,
                 opacity: torch.Tensor, attrs: torch.Tensor,
                 g_image: torch.Tensor, g_weights: torch.Tensor | None,
                 cfg: RasterConfig, n_blended: torch.Tensor | None = None):
    """Launch K5 on CUDA tensors: (g_mean2d, g_conic, g_opacity, g_attrs)
    for the cotangents g_image [num_tiles, 256, A] and g_weights [P] (None
    means zeros), by two front-to-back walks and no walk state. With
    `n_blended` ([num_tiles, 256] int32), K5 also writes each pixel's count
    of blended pairs, which is K1's n_contrib when it rebuilds K1's
    decisions."""
    expect = _inputs("K5", binning, mean2d, conic, opacity, attrs, cfg)
    P, A = attrs.shape
    n_tiles, tt = cfg.num_tiles, cfg.tile * cfg.tile
    expect["g_image"] = (g_image, (n_tiles, tt, A))
    if g_weights is not None:
        expect["g_weights"] = (g_weights, (P,))
    if n_blended is not None:
        expect["n_blended"] = (n_blended, (n_tiles, tt), torch.int32)
    device = attrs.device
    _build.check_tensors("K5", device, expect)
    g_mean2d = torch.zeros((P, 2), dtype=torch.float32, device=device)
    g_conic = torch.zeros((P, 3), dtype=torch.float32, device=device)
    g_opacity = torch.zeros((P,), dtype=torch.float32, device=device)
    g_attrs = torch.zeros((P, A), dtype=torch.float32, device=device)
    _K5(device, binning.tile_start, binning.tile_end, binning.sorted_ids,
        mean2d, conic, opacity, attrs, g_image, g_weights, n_tiles,
        cfg.tiles_x, A, g_mean2d, g_conic, g_opacity, g_attrs, n_blended)
    return g_mean2d, g_conic, g_opacity, g_attrs


def blend_decisions(binning: Binning, mean2d: torch.Tensor,
                    conic: torch.Tensor, opacity: torch.Tensor,
                    pixels: torch.Tensor, cfg: RasterConfig) -> Decisions:
    """The blend decisions at `pixels` ([n] int64 indices into the
    [num_tiles, 256] pixel buffers) and the walk state there: on CPU tensors
    the plain compositor's (`ops/composite.py::blend_decisions`), on CUDA
    tensors K1's, read by the check kernel `csrc/composite_decisions.cu`.
    L is the longest range among the pixels' tiles."""
    tensors = (binning.sorted_ids, binning.tile_start, binning.tile_end,
               mean2d, conic, opacity, pixels)
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return blend_decisions_plain(binning, mean2d, conic, opacity, pixels,
                                     cfg)
    if devices != {"cuda"}:
        raise ValueError(f"blend_decisions: inputs on {sorted(devices)}; "
                         "expected all on CPU or all on CUDA")
    # K1's inputs but attrs (opacity stands in as one channel)
    expect = _inputs("decisions", binning, mean2d, conic, opacity,
                     opacity[:, None], cfg)
    n = pixels.numel()
    expect["pixels"] = (pixels, (n,), torch.int64)
    device = mean2d.device
    _build.check_tensors("decisions", device, expect)
    if n and not (0 <= int(pixels.min()) and int(pixels.max())
                  < cfg.num_tiles * cfg.tile * cfg.tile):
        raise ValueError("blend_decisions: a pixel outside the tiles")
    tiles = pixels // (cfg.tile * cfg.tile)
    L = int((binning.tile_end - binning.tile_start)[tiles].max()) if n else 0
    codes = torch.zeros((n, L), dtype=torch.int8, device=device)
    final_T = torch.empty((n,), dtype=torch.float32, device=device)
    stop = torch.empty((n,), dtype=torch.int32, device=device)
    n_contrib = torch.empty((n,), dtype=torch.int32, device=device)
    _DECISIONS(device, binning.tile_start, binning.tile_end,
               binning.sorted_ids, mean2d, conic, opacity, pixels, n,
               cfg.tiles_x, L, codes, final_T, stop, n_contrib)
    return Decisions(codes=codes, final_T=final_T, stop=stop,
                     n_contrib=n_contrib)

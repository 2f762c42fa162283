"""Plain PyTorch tile compositor (port of relightable3dgaussian_tpu/ops/composite.py::composite).

Front-to-back alpha blending of each 16×16 tile over its depth-sorted pairs,
with the JAX package's rules: power = −½(a·dx² + c·dy²) − b·dx·dy with
dx = mean − pixel at integer pixel coordinates; α = min(0.99, op·e^{min(power,0)});
a pair is skipped where power > 0 or α < 1/255; the blend weight is w = α·T
where the INCOMING transmittance T ≥ 1e-4 (else 0); `n_contrib` counts w > 0.

This is the CPU path, the reference that kernel K1 (ops/composite_cuda.py) is
checked against on the card, and it is differentiable by autograd. Tiles are
batched by range length: a batch of G tiles whose longest range is L costs
G·L·256 elements per intermediate, kept under BATCH_ELEMENTS.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import RasterConfig
from .tiles import Binning

BATCH_ELEMENTS = 1 << 24   # per [G, L, 256] intermediate of one tile batch


class CompositeOut(NamedTuple):
    image: torch.Tensor       # [num_tiles, tile*tile, A] blended attributes
    weights: torch.Tensor     # [P] per-gaussian accumulated blend weight
    n_contrib: torch.Tensor   # [num_tiles, tile*tile] int32 blended count


def _tile_batches(lengths: list[int], max_elements: int) -> list[list[int]]:
    """Group non-empty tiles, longest first, so G·L_max·256 <= max_elements
    (a single tile may exceed it on its own)."""
    order = sorted((t for t, n in enumerate(lengths) if n > 0),
                   key=lambda t: -lengths[t])
    batches: list[list[int]] = []
    for t in order:
        longest = lengths[batches[-1][0]] if batches else 0
        if batches and (len(batches[-1]) + 1) * longest * 256 <= max_elements:
            batches[-1].append(t)
        else:
            batches.append([t])
    return batches


def composite(binning: Binning, mean2d: torch.Tensor, conic: torch.Tensor,
              opacity: torch.Tensor, attrs: torch.Tensor,
              cfg: RasterConfig) -> CompositeOut:
    """Blend depth-sorted gaussians into per-tile pixel buffers.

    Args:
      binning: output of bin_gaussians.
      mean2d: [P, 2]; conic: [P, 3]; opacity: [P] activated opacities.
      attrs: [P, A] per-gaussian blended attributes (rgb, features, depth, 1).

    Returns:
      CompositeOut with image [num_tiles, tile², A]; weights are zeros when
      cfg.compute_weights is False.
    """
    P, A = attrs.shape
    dev = attrs.device
    tile = cfg.tile
    tt = tile * tile
    start = binning.tile_start.to(torch.int64)
    lengths = (binning.tile_end.to(torch.int64) - start)
    ids_all = binning.sorted_ids.to(torch.int64)

    lx = torch.arange(tile, device=dev, dtype=torch.float32)
    px_local = lx.repeat(tile)                 # pixel p: x = p % tile
    py_local = lx.repeat_interleave(tile)      #          y = p // tile

    tiles_done, images, counts = [], [], []
    w_ids, w_sums = [], []
    for batch in _tile_batches(lengths.tolist(), BATCH_ELEMENTS):
        tb = torch.tensor(batch, device=dev, dtype=torch.int64)
        L = int(lengths[batch[0]])
        k = torch.arange(L, device=dev)
        valid = k[None, :] < lengths[tb][:, None]                 # [G, L]
        slots = torch.where(valid, start[tb][:, None] + k[None, :], 0)
        ids = ids_all[slots]                                      # [G, L]

        xy = mean2d[ids]
        con = conic[ids]
        op = opacity[ids]
        px = (tb % cfg.tiles_x).to(torch.float32)[:, None] * tile + px_local
        py = (tb // cfg.tiles_x).to(torch.float32)[:, None] * tile + py_local
        dx = xy[..., 0][:, :, None] - px[:, None, :]              # [G, L, tt]
        dy = xy[..., 1][:, :, None] - py[:, None, :]
        power = (-0.5 * (con[..., 0][:, :, None] * dx * dx
                         + con[..., 2][:, :, None] * dy * dy)
                 - con[..., 1][:, :, None] * dx * dy)
        alpha = torch.clamp(
            op[:, :, None] * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
        ok = (power <= 0.0) & (alpha >= 1.0 / 255.0) & valid[:, :, None]
        alpha = torch.where(ok, alpha, 0.0)

        # Exclusive transmittance along the depth-sorted range.
        cum = torch.cumprod(1.0 - alpha, dim=1)
        T_at = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        w = torch.where(T_at >= 1e-4, alpha * T_at, 0.0)          # [G, L, tt]

        images.append(torch.einsum("glt,gla->gta", w, attrs[ids]))
        counts.append((w > 0).sum(1).to(torch.int32))
        tiles_done.append(tb)
        if cfg.compute_weights:
            w_ids.append(ids[valid])
            w_sums.append(w.sum(-1)[valid])

    image = torch.zeros((cfg.num_tiles, tt, A), dtype=attrs.dtype, device=dev)
    n_contrib = torch.zeros((cfg.num_tiles, tt), dtype=torch.int32, device=dev)
    weights = torch.zeros((P,), dtype=attrs.dtype, device=dev)
    if tiles_done:
        tiles_cat = torch.cat(tiles_done)
        image = image.index_copy(0, tiles_cat, torch.cat(images))
        n_contrib = n_contrib.index_copy(0, tiles_cat, torch.cat(counts))
        if cfg.compute_weights:
            weights = weights.index_add(0, torch.cat(w_ids), torch.cat(w_sums))
    return CompositeOut(image=image, weights=weights, n_contrib=n_contrib)


def tiles_to_image(tile_buf: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """[num_tiles, tile*tile, A] → [A, H, W] (cropping tile padding)."""
    A = tile_buf.shape[-1]
    img = tile_buf.reshape(cfg.tiles_y, cfg.tiles_x, cfg.tile, cfg.tile, A)
    img = img.permute(4, 0, 2, 1, 3).reshape(
        A, cfg.tiles_y * cfg.tile, cfg.tiles_x * cfg.tile)
    return img[:, :cfg.height, :cfg.width]

"""Tile binning with buffers sized per call.

Port of `relightable3dgaussian_tpu/ops/tiles.py::bin_gaussians`.

One (gaussian, tile) pair is emitted per tile of a gaussian's rect, minus the
pairs the exact per-tile cull (`_tile_min_power`) proves blend nothing: the
gaussian's largest alpha over the tile's pixel box is below 1/255. Pairs are
ordered by the int64 key `(tile << 32) | depth_rank`, where the depth rank
comes from a stable argsort of the view-space depth, so one `torch.sort` gives
the (tile, depth, id) order of the JAX package. Per-tile `[start, end)` ranges
follow from the sorted tile ids.

The JAX package's tier plan, pair budget, duplication cap and overflow
counters exist because TPU buffers have static shapes; here the buffers are
sized from the pair count and no pair is ever dropped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import trace
from .config import RasterConfig
from .projection import Preprocessed


class Binning(NamedTuple):
    sorted_ids: torch.Tensor   # [num_rendered] int32 gaussian ids, (tile, depth)-sorted
    tile_start: torch.Tensor   # [num_tiles] int32 range start into sorted_ids
    tile_end: torch.Tensor     # [num_tiles] int32 range end (exclusive)
    num_rendered: int          # pairs emitted


def _tile_min_power(mean2d, conic, tx, ty, tile: int):
    """Exact minimum of q(d) = a dx² + 2b dx dy + c dy² over each pair's tile
    pixel box (per pair: mean2d [N, 2], conic [N, 3], tx/ty [N] int)."""
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    x0 = tx.to(torch.float32) * tile
    y0 = ty.to(torch.float32) * tile
    dx_lo = mean2d[:, 0] - (x0 + tile - 1)
    dx_hi = mean2d[:, 0] - x0
    dy_lo = mean2d[:, 1] - (y0 + tile - 1)
    dy_hi = mean2d[:, 1] - y0
    inside = (dx_lo <= 0) & (dx_hi >= 0) & (dy_lo <= 0) & (dy_hi >= 0)

    def q(dx, dy):
        return a * dx * dx + 2.0 * b * dx * dy + c * dy * dy

    def edge_x(dx_fixed):   # minimize over dy in [dy_lo, dy_hi]
        dy_star = torch.minimum(torch.maximum(
            -b * dx_fixed / torch.clamp(c, min=1e-12), dy_lo), dy_hi)
        return q(dx_fixed, dy_star)

    def edge_y(dy_fixed):
        dx_star = torch.minimum(torch.maximum(
            -b * dy_fixed / torch.clamp(a, min=1e-12), dx_lo), dx_hi)
        return q(dx_star, dy_fixed)

    qmin = torch.minimum(
        torch.minimum(edge_x(dx_lo), edge_x(dx_hi)),
        torch.minimum(edge_y(dy_lo), edge_y(dy_hi)))
    return torch.where(inside, 0.0, torch.clamp(qmin, min=0.0))


def bin_gaussians(prep: Preprocessed, cfg: RasterConfig,
                  opacity: torch.Tensor | None = None) -> Binning:
    """Bin gaussians into (tile, depth)-ordered pairs.

    Args:
      prep: preprocess() output.
      opacity: optional [P] activated opacities; when given, pairs whose
        largest alpha over the tile is below 1/255 are culled
        (output-identical: every compositor skips them per pixel anyway).
    """
    with trace.span("render.binning"):
        dev = prep.depth.device
        P = prep.depth.shape[0]
        counts = prep.tiles_touched.to(torch.int64)
        total = int(counts.sum())
        trace.count("host.syncs")

        # Depth ranks: stable order of view-space depth (ties broken by index).
        depth_order = torch.argsort(prep.depth.detach(), stable=True)
        rank_of = torch.empty_like(depth_order)
        rank_of[depth_order] = torch.arange(P, device=dev)

        gid = torch.repeat_interleave(torch.arange(P, device=dev), counts,
                                      output_size=total)
        first = torch.cumsum(counts, 0) - counts
        j = torch.arange(total, device=dev) - first[gid]
        # Per-pair gathers of 1-D columns: gathering the [P, 2] int64 rows
        # (16 B each) took 0.71 ms per 800x800, 100k-gaussian view on an H100
        # (700 W), several times the two column gathers together.
        rect_x = prep.rect_min[:, 0].to(torch.int64)[gid]
        rect_y = prep.rect_min[:, 1].to(torch.int64)[gid]
        span_x = torch.clamp(prep.rect_max[:, 0] - prep.rect_min[:, 0],
                             min=1).to(torch.int64)[gid]
        jq = j // span_x
        ty = rect_y + jq
        tx = rect_x + j - jq * span_x
        if opacity is not None:
            q_min = _tile_min_power(prep.mean2d.detach()[gid],
                                    prep.conic.detach()[gid], tx, ty, cfg.tile)
            th = 2.0 * torch.log(torch.clamp(opacity.detach(), min=1e-12) * 255.0)
            keep = q_min <= th[gid]
            gid, tx, ty = gid[keep], tx[keep], ty[keep]
            trace.count("host.syncs", 3)    # each selection's size

        tile = ty * cfg.tiles_x + tx
        key, _ = torch.sort((tile << 32) | rank_of[gid])
        sorted_ids = depth_order[key & 0xFFFFFFFF].to(torch.int32)
        per_tile = torch.bincount(key >> 32, minlength=cfg.num_tiles)
        trace.count("host.syncs", 2)        # bincount reads min and max
        tile_end = torch.cumsum(per_tile, 0)
        tile_start = tile_end - per_tile
        return Binning(sorted_ids=sorted_ids,
                       tile_start=tile_start.to(torch.int32),
                       tile_end=tile_end.to(torch.int32),
                       num_rendered=int(sorted_ids.shape[0]))

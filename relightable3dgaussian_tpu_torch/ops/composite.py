"""Plain PyTorch tile compositor (port of relightable3dgaussian_tpu/ops/composite.py::composite).

Front-to-back alpha blending of each 16×16 tile over its depth-sorted pairs,
with the JAX package's rules: power = −½(a·dx² + c·dy²) − b·dx·dy with
dx = mean − pixel at integer pixel coordinates; α = min(0.99, op·e^{min(power,0)});
a pair is skipped where power > 0 or α < 1/255; the blend weight is w = α·T
where the INCOMING transmittance T ≥ 1e-4 (else 0); `n_contrib` counts w > 0.

This is the CPU path, the reference that kernel K1 (ops/composite_cuda.py) is
checked against on the card, and it is differentiable by autograd;
`composite_backward`, its vector-Jacobian product, is the plain version of
kernel K2. Tiles are
batched by range length: a batch of G tiles whose longest range is L costs
G·L·256 elements per intermediate, kept under BATCH_ELEMENTS.

For checks only: `walk_state` and `split_pixels` (where two compositors
blended other pairs), `blend_decisions` (which pairs a pixel blended), and
`replay`/`replay_backward`, which composite given pixels over the pairs a
walk's decisions name, in float64, taking no decision of their own: K2 is
held to that VJP of K1's decisions where K1 and this compositor part.
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


class WalkState(NamedTuple):
    """Per pixel, where the front-to-back walk stopped: what K1 writes for
    K2, and `walk_state` computes from the plain blend."""
    final_T: torch.Tensor   # [num_tiles, 256] f32 transmittance at the stop
    stop: torch.Tensor      # [num_tiles, 256] i32 one past the last pair walked


class _Blend(NamedTuple):
    """One batch of tiles blended: what composite and its backward read."""
    tiles: torch.Tensor       # [G] tile ids
    image: torch.Tensor       # [G, tile², A]
    w: torch.Tensor           # [G, L, tile²] blend weights
    ids: torch.Tensor         # [G, L] gaussian ids (0 where not valid)
    valid: torch.Tensor       # [G, L] slot lies in the tile's range
    cum: torch.Tensor         # [G, L, tile²] transmittance after each slot
    alpha: torch.Tensor       # [G, L, tile²] alpha (0 where skipped)


def _batches(binning: Binning, cfg: RasterConfig, mean2d, conic, opacity,
             attrs):
    """Blend the tiles batch by batch (a generator of _Blend)."""
    dev = attrs.device
    tile = cfg.tile
    start = binning.tile_start.to(torch.int64)
    lengths = (binning.tile_end.to(torch.int64) - start)
    ids_all = binning.sorted_ids.to(torch.int64)

    lx = torch.arange(tile, device=dev, dtype=torch.float32)
    px_local = lx.repeat(tile)                 # pixel p: x = p % tile
    py_local = lx.repeat_interleave(tile)      #          y = p // tile

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
        yield _Blend(tiles=tb, image=torch.einsum("glt,gla->gta", w, attrs[ids]),
                     w=w, ids=ids, valid=valid, cum=cum, alpha=alpha)


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
    tt = cfg.tile * cfg.tile
    tiles_done, images, counts = [], [], []
    w_ids, w_sums = [], []
    for b in _batches(binning, cfg, mean2d, conic, opacity, attrs):
        images.append(b.image)
        counts.append((b.w > 0).sum(1).to(torch.int32))
        tiles_done.append(b.tiles)
        if cfg.compute_weights:
            w_ids.append(b.ids[b.valid])
            w_sums.append(b.w.sum(-1)[b.valid])

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


def composite_backward(binning: Binning, mean2d: torch.Tensor,
                       conic: torch.Tensor, opacity: torch.Tensor,
                       attrs: torch.Tensor, g_image: torch.Tensor,
                       g_weights: torch.Tensor | None, cfg: RasterConfig):
    """The plain version of kernel K2: the vector-Jacobian product of
    `composite` for the cotangents g_image [num_tiles, tile², A] and
    g_weights [P] (None means zeros), by torch.autograd.grad through the
    plain compositor. Tiles blend independently, so it runs one tile batch
    at a time and sums: memory stays that of one batch.

    Returns (g_mean2d [P, 2], g_conic [P, 3], g_opacity [P], g_attrs [P, A]).
    """
    leaves = [x.detach().requires_grad_() for x in
              (mean2d, conic, opacity, attrs)]
    grads = [torch.zeros_like(x) for x in leaves]
    use_w = g_weights is not None and cfg.compute_weights
    with torch.enable_grad():
        for b in _batches(binning, cfg, *leaves):
            objective = (b.image * g_image[b.tiles]).sum()
            if use_w:
                objective = objective + (b.w.sum(-1)[b.valid]
                                         * g_weights[b.ids[b.valid]]).sum()
            for g, d in zip(grads, torch.autograd.grad(
                    objective, leaves, allow_unused=True)):
                if d is not None:
                    g += d
    return tuple(grads)


def walk_state(binning: Binning, mean2d: torch.Tensor, conic: torch.Tensor,
               opacity: torch.Tensor, cfg: RasterConfig) -> WalkState:
    """The plain compositor's walk state, in K1's terms: per pixel, the
    transmittance after its last blended pair (1 where it blends none), and
    one past the index in the tile's range of the blended pair that took T
    under 1e-4, or the range's length where T never fell under it."""
    dev = mean2d.device
    tt = cfg.tile * cfg.tile
    final_T = torch.ones((cfg.num_tiles, tt), dtype=torch.float32, device=dev)
    stop = torch.zeros((cfg.num_tiles, tt), dtype=torch.int32, device=dev)
    lengths = (binning.tile_end - binning.tile_start).to(torch.int64)
    ones = mean2d.new_ones((mean2d.shape[0], 1))
    for b in _batches(binning, cfg, mean2d, conic, opacity, ones):
        blended = b.w > 0                                         # [G, L, tt]
        ended = blended & (b.cum < 1e-4)
        L = blended.shape[1]
        k = torch.arange(L, device=dev)[None, :, None]
        # one past the last blended pair (the ending one, where T ended)
        last = torch.where(blended, k + 1, 0).amax(1)             # [G, tt]
        T = torch.gather(b.cum, 1, (last - 1).clamp(min=0)[:, None])[:, 0]
        final_T[b.tiles] = torch.where(last > 0, T, 1.0)
        stop[b.tiles] = torch.where(ended.any(1), last,
                                    lengths[b.tiles][:, None]).to(torch.int32)
    return WalkState(final_T=final_T, stop=stop)


# A blend decision that differs at alpha >= 1/255 changes a pixel's final T
# by a factor of at most 1 - 1/255, 3.9e-3 of it. Two walks that blend the
# same pairs round their T apart by one ulp of each of its factors (at most a
# few thousand, 6e-8 each) and, through 1 - alpha, by alpha / (1 - alpha)
# times alpha's few ulps (at most 99 x 2.4e-7 a factor at the 0.99 cap, and
# at most two such factors before T < 1e-4): at most ~2e-4 in all. SPLIT_T_RTOL
# lies between the two.
SPLIT_T_RTOL = 1e-3


def split_pixels(n_contrib_a: torch.Tensor, walk_a: WalkState,
                 n_contrib_b: torch.Tensor, walk_b: WalkState) -> torch.Tensor:
    """[num_tiles, 256] mask of the pixels where two compositors blended
    other pairs: their counts differ, their walks ended at other pairs, or
    their final T differ by more than SPLIT_T_RTOL of it. A pair at alpha ~
    1/255 blended on one side only, with the T = 1e-4 end moved one pair the
    other way, keeps the counts equal; it moves the stop, and the final T by
    the ratio of the two pairs' 1 - alpha."""
    return ((n_contrib_a != n_contrib_b) | (walk_a.stop != walk_b.stop)
            | ((walk_a.final_T - walk_b.final_T).abs()
               > SPLIT_T_RTOL * walk_b.final_T.abs()))


# Blend decisions (Decisions.codes): not blended, blended, blended at the
# 0.99 cap on alpha (where no gradient reaches op · e^power).
SKIP, BLEND, BLEND_AT_CAP = 0, 1, 2
ALPHA_CAP = float(torch.tensor(0.99, dtype=torch.float32))   # 0.99 in float32


class Decisions(NamedTuple):
    """A compositor's walk at a list of pixels: the decision for each pair
    of the pixel's tile range, in range order, and the walk state there."""
    codes: torch.Tensor      # [n, L] int8 SKIP, BLEND or BLEND_AT_CAP
    final_T: torch.Tensor    # [n] f32
    stop: torch.Tensor       # [n] i32
    n_contrib: torch.Tensor  # [n] i32 pairs blended


def blend_decisions(binning: Binning, mean2d: torch.Tensor,
                    conic: torch.Tensor, opacity: torch.Tensor,
                    pixels: torch.Tensor, cfg: RasterConfig) -> Decisions:
    """The plain compositor's decisions at `pixels` ([n] int64 indices into
    the [num_tiles * tile²] pixel buffers), with L the longest range among
    their tiles; pairs past a pixel's stop are SKIP. The plain version of
    the check kernel `composite_cuda.blend_decisions`, which reads K1's."""
    dev = mean2d.device
    tt = cfg.tile * cfg.tile
    tiles = pixels // tt
    lengths = (binning.tile_end - binning.tile_start).to(torch.int64)
    L = int(lengths[tiles].max()) if pixels.numel() else 0
    codes = torch.zeros((pixels.numel(), L), dtype=torch.int8, device=dev)
    slot_of = torch.full((cfg.num_tiles,), -1, dtype=torch.int64, device=dev)
    ones = mean2d.new_ones((mean2d.shape[0], 1))
    for b in _batches(binning, cfg, mean2d, conic, opacity, ones):
        slot_of[b.tiles] = torch.arange(b.tiles.numel(), device=dev)
        rows = torch.nonzero(slot_of[tiles] >= 0).flatten()
        g, p = slot_of[tiles[rows]], pixels[rows] % tt
        # the batch's longest range may be another tile's, longer than L
        w, alpha = b.w[g, :L, p], b.alpha[g, :L, p]             # [m, <= L]
        codes[rows, :w.shape[1]] = torch.where(
            w > 0, torch.where(alpha == ALPHA_CAP, BLEND_AT_CAP, BLEND),
            SKIP).to(torch.int8)
        slot_of[b.tiles] = -1
    walk = walk_state(binning, mean2d, conic, opacity, cfg)
    return Decisions(codes=codes, final_T=walk.final_T.flatten()[pixels],
                     stop=walk.stop.flatten()[pixels],
                     n_contrib=(codes > 0).sum(1).to(torch.int32))


REPLAY_ELEMENTS = 1 << 22   # (pixel, slot) elements per replayed chunk


def replay(binning: Binning, mean2d: torch.Tensor, conic: torch.Tensor,
           opacity: torch.Tensor, attrs: torch.Tensor, pixels: torch.Tensor,
           codes: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """[n, A] blended attributes of `pixels` over exactly the pairs `codes`
    ([n, L], as `blend_decisions` gives) blends, in the dtype of the inputs
    and differentiable by autograd: alpha = op · e^power where BLEND, the
    float32 0.99 where BLEND_AT_CAP; w = alpha · T over the blended pairs.
    No decision is taken here, so the VJP is that of the walk that took
    them. For checks (float64 inputs), never on a main path."""
    tt = cfg.tile * cfg.tile
    tiles = pixels // tt
    p = pixels % tt
    k = torch.arange(codes.shape[1], device=codes.device)
    blended = codes > 0
    slots = torch.where(blended, binning.tile_start.to(torch.int64)[tiles][:, None]
                        + k, 0)
    ids = binning.sorted_ids.to(torch.int64)[slots]             # [n, L]
    px = ((tiles % cfg.tiles_x) * cfg.tile + p % cfg.tile).to(mean2d.dtype)
    py = ((tiles // cfg.tiles_x) * cfg.tile + p // cfg.tile).to(mean2d.dtype)
    dx = mean2d[ids, 0] - px[:, None]
    dy = mean2d[ids, 1] - py[:, None]
    con = conic[ids]
    power = (-0.5 * (con[..., 0] * dx * dx + con[..., 2] * dy * dy)
             - con[..., 1] * dx * dy)
    alpha = torch.where(codes == BLEND_AT_CAP, ALPHA_CAP,
                        opacity[ids] * torch.exp(power))
    alpha = torch.where(blended, alpha, 0.0)
    cum = torch.cumprod(1.0 - alpha, dim=1)
    T = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    return torch.einsum("nl,nla->na", alpha * T, attrs[ids])


def replay_backward(binning: Binning, mean2d: torch.Tensor,
                    conic: torch.Tensor, opacity: torch.Tensor,
                    attrs: torch.Tensor, pixels: torch.Tensor,
                    codes: torch.Tensor, g_pixels: torch.Tensor,
                    cfg: RasterConfig):
    """The float64 VJP of `replay` for the cotangent g_pixels [n, A]:
    (g_mean2d [P, 2], g_conic [P, 3], g_opacity [P], g_attrs [P, A]), by
    autograd, summed over chunks of pixels."""
    leaves = [x.detach().to(torch.float64).requires_grad_() for x in
              (mean2d, conic, opacity, attrs)]
    grads = [torch.zeros_like(x) for x in leaves]
    step = max(1, REPLAY_ELEMENTS // max(codes.shape[1], 1))
    with torch.enable_grad():
        for i in range(0, pixels.numel(), step):
            out = replay(binning, *leaves, pixels[i:i + step],
                         codes[i:i + step], cfg)
            objective = (out * g_pixels[i:i + step].to(torch.float64)).sum()
            for g, d in zip(grads, torch.autograd.grad(
                    objective, leaves, allow_unused=True)):
                if d is not None:
                    g += d
    return tuple(grads)


def tiles_to_image(tile_buf: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """[num_tiles, tile*tile, A] → [A, H, W] (cropping tile padding)."""
    A = tile_buf.shape[-1]
    img = tile_buf.reshape(cfg.tiles_y, cfg.tiles_x, cfg.tile, cfg.tile, A)
    img = img.permute(4, 0, 2, 1, 3).reshape(
        A, cfg.tiles_y * cfg.tile, cfg.tiles_x * cfg.tile)
    return img[:, :cfg.height, :cfg.width]

"""Cascade plane-sweep stereo in torch, on the card.

Port of relightable3dgaussian_tpu/mvs/plane_sweep.py, the weight-free
stand-in for the reference's Vis-MVSNet inference (whose checkpoint the
reference snapshot does not hold). It produces the same artifacts, a depth
map and three per-stage probability maps:

  * stage s runs at 1/4, 1/2, 1/1 resolution (at least 48 pixels a side)
    with D_s depth hypotheses; stage 1 sweeps [depth_min, depth_max] evenly
    in inverse depth, later stages a band around the upsampled previous
    depth, with a parabola through the best hypothesis and its neighbours;
  * the photometric cost is the mean windowed ZNCC over the source views,
    from box-filter window statistics; a view scores at a pixel only where
    its whole window warped in-bounds;
  * depth = streaming soft-argmin over hypotheses (chunks of 8 planes in
    stage 1, so the [D, H, W] volume is never held), probability = the
    softmax mass of the winning hypothesis.

The JAX package scans the hypotheses with lax.scan; here a Python loop over
chunks on the device carries the same state. The box filter is a direct
k-tap sum with zero padding (a cumulative sum would round the `full`
window test otherwise), the warp is the JAX package's four-tap gather with
zeros outside the image, and `rel` is formed in float64 in numpy before it
is cast to float32, all as the JAX code computes them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..scene.image_io import resize2d
from .formats import MVSCamera

CHUNK = 8       # stage-1 hypotheses swept at once


def _gray(img: torch.Tensor) -> torch.Tensor:
    """[3, H, W] or [H, W] → [H, W] luminance."""
    if img.ndim == 2:
        return img
    return 0.299 * img[0] + 0.587 * img[1] + 0.114 * img[2]


def _box(x: torch.Tensor, k: int) -> torch.Tensor:
    """SAME box filter of window k over the last two axes, zero padded: a
    k-tap sum along each axis in turn."""
    w = torch.ones((), dtype=x.dtype, device=x.device) / k
    pad = k // 2
    n = x.shape[-1]
    xp = torch.nn.functional.pad(x, (pad, pad))
    out = xp[..., 0:n] * w
    for i in range(1, k):
        out = out + xp[..., i:i + n] * w
    n = x.shape[-2]
    xp = torch.nn.functional.pad(out, (0, 0, pad, pad))
    out = xp[..., 0:n, :] * w
    for i in range(1, k):
        out = out + xp[..., i:i + n, :] * w
    return out


def _ref_stats(ref: torch.Tensor, k: int):
    """The reference's window mean and variance, shared by every
    hypothesis."""
    mu_r = _box(ref, k)
    return ref, mu_r, torch.clamp(_box(ref * ref, k) - mu_r * mu_r, min=0.0)


def _zncc(ref_stats, warped: torch.Tensor, valid: torch.Tensor, k: int = 7,
          eps: float = 1e-5):
    """Windowed ZNCC between the [H, W] reference and [..., H, W] warped
    views → (ncc, eff), ncc zero where eff is False.

    A pixel scores only where its whole window warped in-bounds: zeros in
    the window statistics would otherwise poison the correlation in a
    k-wide band along the frustum borders.
    """
    ref, mu_r, var_r = ref_stats
    mu_w = _box(warped, k)
    var_w = torch.clamp(_box(warped * warped, k) - mu_w * mu_w, min=0.0)
    cov = _box(ref * warped, k) - mu_r * mu_w
    ncc = cov / torch.sqrt((var_r + eps) * (var_w + eps))
    full = _box(valid.to(ref.dtype), k) > 1.0 - 0.5 / (k * k)
    eff = valid & full
    return torch.where(eff, torch.clamp(ncc, -1.0, 1.0), 0.0), eff


def _warp(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear samples of the [V, H, W] images at pixel coordinates x, y
    [..., V, h, w], zero outside the image → (values, in-bounds), a sample
    in-bounds where its top-left and bottom-right taps are."""
    V, H, W = src.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    flat = src.reshape(V, H * W)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (yi.long().clamp(0, H - 1) * W + xi.long().clamp(0, W - 1))
        idx = idx.movedim(-3, 0)
        v = torch.gather(flat, 1, idx.reshape(V, -1)).reshape(idx.shape)
        return torch.where(inb, v.movedim(0, -3), 0.0), inb

    v00, m00 = tap(x0, y0)
    v10, _ = tap(x0 + 1, y0)
    v01, _ = tap(x0, y0 + 1)
    v11, m11 = tap(x0 + 1, y0 + 1)
    out = (v00 * (1 - wx) * (1 - wy) + v10 * wx * (1 - wy)
           + v01 * (1 - wx) * wy + v11 * wx * wy)
    return out, m00 & m11


def _pixel_rays(K_inv: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[3, H, W] camera rays K⁻¹ (x + ½, y + ½, 1)."""
    dev = K_inv.device
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    pix = (xs, ys, torch.ones_like(xs))
    return torch.stack([K_inv[i, 0] * pix[0] + K_inv[i, 1] * pix[1]
                        + K_inv[i, 2] * pix[2] for i in range(3)])


def _apply(M: torch.Tensor, p) -> list[torch.Tensor]:
    """Rows of M [V, r, c] times the c planes of p (each [..., H, W],
    broadcast over V) → r planes [..., V, H, W]."""
    return [sum(M[:, i, j, None, None] * p[j] for j in range(len(p)))
            for i in range(M.shape[1])]


def _score(ref_stats, srcs, rays, rel, K_srcs, depth, win: int):
    """Mean ZNCC over the sources of the reference's pixels at `depth`
    ([C, 1, 1] planes or [C, H, W] maps) → [C, H, W]."""
    pc = [rays[i] * depth for i in range(3)]              # [C, H, W] each
    ph = [p[:, None] for p in pc] + [1.0]                 # [C, 1, H, W]
    ps = _apply(rel[:, :3], ph)                           # [C, V, H, W]
    u, v, z = _apply(K_srcs, ps)
    x = u / torch.clamp(z, min=1e-6) - 0.5
    y = v / torch.clamp(z, min=1e-6) - 0.5
    warped, inb = _warp(srcs, x, y)
    valid = inb & (z > 1e-4)
    ncc, eff = _zncc(ref_stats, warped, valid, k=win)
    nv = torch.clamp(eff.sum(-3), min=1)
    return ncc.sum(-3) / nv


def _sweep(ref_g, srcs_g, K_ref_inv, K_srcs, rel, depths, beta: float,
           chunk: int = CHUNK, win: int = 7):
    """Sweep the [D] hypothesis depths, CHUNK at a time, with a streaming
    soft-argmin → (depth [H, W], prob [H, W])."""
    H, W = ref_g.shape
    D = depths.shape[0]
    rays = _pixel_rays(K_ref_inv, H, W)
    stats = _ref_stats(ref_g, win)
    pad = (-D) % chunk
    dpad = torch.cat([depths, depths[-1:].expand(pad)]) if pad else depths
    neg = torch.full((H, W), -torch.inf, device=ref_g.device)
    m, Z, Sd = neg, torch.zeros_like(neg), torch.zeros_like(neg)
    best_s, best_d = neg, depths[0].expand(H, W)
    for c0 in range(0, dpad.shape[0], chunk):
        dc = dpad[c0:c0 + chunk]
        s = _score(stats, srcs_g, rays, rel, K_srcs, dc[:, None, None], win)
        live = (torch.arange(c0, c0 + chunk, device=dc.device) < D)
        s = torch.where(live[:, None, None], beta * s, -torch.inf)
        s_max, ib = s.max(0).values, s.argmax(0)
        m_new = torch.maximum(m, s_max)
        scale = torch.exp(m - m_new)
        e = torch.exp(s - m_new[None])
        Z = Z * scale + e.sum(0)
        Sd = Sd * scale + (e * dc[:, None, None]).sum(0)
        better = s_max > best_s
        best_s = torch.where(better, s_max, best_s)
        best_d = torch.where(better, dc[ib], best_d)
        m = m_new
    depth = Sd / torch.clamp(Z, min=1e-12)
    prob = torch.exp(best_s - m) / torch.clamp(Z, min=1e-12)
    return depth, prob


def _sweep_local(ref_g, srcs_g, K_ref_inv, K_srcs, rel, prev_depth, offs,
                 beta: float, dmin: float, dmax: float, win: int = 7):
    """Band sweep: per-pixel hypotheses prev_depth + offs, one at a time,
    with a parabola through the best hypothesis and its neighbours (the
    classical stand-in for the network's learned regression)."""
    H, W = ref_g.shape
    rays = _pixel_rays(K_ref_inv, H, W)
    stats = _ref_stats(ref_g, win)
    lo, hi = (torch.tensor(v, dtype=torch.float32, device=ref_g.device)
              for v in (dmin, dmax))
    neg = torch.full((H, W), -torch.inf, device=ref_g.device)
    m, Z, best_s, left_s, right_s, prev_s = (
        neg, torch.zeros_like(neg), neg, neg, neg, neg)
    best_d = prev_depth + offs[0]
    prev_best = torch.zeros((H, W), dtype=torch.bool, device=ref_g.device)
    for off in offs:
        dmap = torch.minimum(torch.maximum(prev_depth + off, lo), hi)
        s = beta * _score(stats, srcs_g, rays, rel, K_srcs, dmap[None],
                          win)[0]
        m_new = torch.maximum(m, s)
        Z = Z * torch.exp(m - m_new) + torch.exp(s - m_new)
        better = s > best_s
        right_s = torch.where(prev_best, s, right_s)   # after the old best
        left_s = torch.where(better, prev_s, left_s)
        best_d = torch.where(better, dmap, best_d)
        best_s = torch.where(better, s, best_s)
        right_s = torch.where(better, -torch.inf, right_s)
        m, prev_s, prev_best = m_new, s, better
    step = offs[1] - offs[0]
    ok = torch.isfinite(left_s) & torch.isfinite(right_s)
    denom = left_s - 2.0 * best_s + right_s
    curved = denom < -1e-9
    delta = torch.where(ok & curved, 0.5 * (left_s - right_s) / torch.where(
        curved, denom, -1.0), 0.0)
    depth = torch.minimum(torch.maximum(
        best_d + torch.clamp(delta, -0.5, 0.5) * step, lo), hi)
    prob = torch.exp(best_s - m) / torch.clamp(Z, min=1e-12)
    return depth, prob


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """jnp.linspace in float32: start (1 - t) + stop t at t = i / (num - 1),
    the last value stop itself."""
    a, b = (torch.tensor(v, dtype=torch.float32, device=device)
            for v in (start, stop))
    t = torch.arange(num - 1, dtype=torch.float32, device=device) / float(
        num - 1)
    return torch.cat([a * (1 - t) + b * t, b[None]])


def _scale_K(K: torch.Tensor, s: float) -> torch.Tensor:
    K = K.clone()
    K[..., :2, :] = K[..., :2, :] * s
    return K


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


@torch.no_grad()
def infer_depth(ref_img, src_imgs, ref_cam: MVSCamera,
                src_cams: list[MVSCamera], stage_planes=(48, 32, 16),
                band=(None, 9.0, 3.0), beta: float = 20.0,
                stage_wins=(7, 7, 5), device: torch.device | str = "cuda"):
    """Cascade depth inference for one reference view, on `device` (the
    card unless the caller asks for the CPU).

    Args:
      ref_img: [3, H, W] float in [0, 1]; src_imgs: [V, 3, H, W] (arrays or
        tensors).
      stage_planes: hypotheses per stage (1/4, 1/2, 1/1 resolution).
      band: half-width of the local search band (in stage-1 intervals) for
        the stages after the first.
    Returns (depth [H, W], a list of 3 [H, W] probability maps at full
    resolution), float32 tensors on `device`.
    """
    device = torch.device(device)
    H, W = ref_img.shape[-2:]
    ref_g = _gray(_as_f32(ref_img, device))
    srcs_g = torch.stack([_gray(_as_f32(s, device)) for s in src_imgs])
    ref_inv = np.linalg.inv(np.asarray(ref_cam.extrinsic, np.float64))
    rel = _as_f32(np.stack([np.asarray(c.extrinsic, np.float64) @ ref_inv
                            for c in src_cams]).astype(np.float32), device)
    K_ref = _as_f32(ref_cam.intrinsic, device)
    K_srcs = torch.stack([_as_f32(c.intrinsic, device) for c in src_cams])

    dmin = max(float(ref_cam.depth_min), 1e-4)
    dmax = max(float(ref_cam.depth_max), dmin * 1.01)

    depth = None
    probs = []
    for s_i, (planes, sc) in enumerate(zip(stage_planes, (0.25, 0.5, 1.0))):
        # the pyramid's floor keeps enough context for ZNCC on small images
        h = min(max(int(round(H * sc)), 48), H)
        w = min(max(int(round(W * sc)), 48), W)
        rg = resize2d(ref_g, h, w)
        sg = resize2d(srcs_g, h, w)
        Kr_inv = torch.linalg.inv(_scale_K(K_ref, w / W))
        Ks = _scale_K(K_srcs, w / W)
        if depth is None:
            inv = _linspace(1.0 / dmax, 1.0 / dmin, planes, device)
            d, p = _sweep(rg, sg, Kr_inv, Ks, rel, 1.0 / inv.flip(0), beta,
                          win=stage_wins[s_i])
        else:
            half = band[s_i] * (dmax - dmin) / stage_planes[0]
            d, p = _sweep_local(rg, sg, Kr_inv, Ks, rel,
                                resize2d(depth, h, w),
                                _linspace(-half, half, planes, device),
                                beta, dmin, dmax, win=stage_wins[s_i])
        depth = d
        probs.append(resize2d(p, H, W))
    return resize2d(depth, H, W), probs

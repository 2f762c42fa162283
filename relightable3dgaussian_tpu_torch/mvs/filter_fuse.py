"""Depth-map filtering: photometric confidence and cross-view consistency.

Port of relightable3dgaussian_tpu/mvs/filter_fuse.py, in torch on the card,
with the reference filter.py's acceptance rules:
  * prob_filter: all three stage probabilities above their thresholds;
  * geometric_filter: a reference pixel survives where at least vthresh
    source views reproject consistently, the source depth re-projected into
    the reference landing within 1 px and 1% relative depth.
"""
from __future__ import annotations

import numpy as np
import torch

from .formats import MVSCamera
from .plane_sweep import _as_f32, _pixel_rays, _warp


def prob_filter(probs, pthresh=(0.6, 0.6, 0.6)) -> torch.Tensor:
    """probs: a list (or stack) of [H, W] maps, on one device → [H, W]
    bool mask there."""
    probs = torch.stack([torch.as_tensor(p) for p in probs])
    th = torch.tensor(pthresh, dtype=probs.dtype, device=probs.device)
    return (probs > th[:, None, None]).all(0)


def _cam_arrays(cam: MVSCamera, device):
    return (_as_f32(np.asarray(cam.extrinsic, np.float64), device),
            _as_f32(np.asarray(cam.intrinsic, np.float64), device))


def _mat(M: torch.Tensor, p) -> list[torch.Tensor]:
    """M [r, c] times the c planes of p → r planes."""
    return [sum(M[i, j] * p[j] for j in range(len(p)))
            for i in range(M.shape[0])]


@torch.no_grad()
def geometric_filter(ref_depth, ref_cam: MVSCamera, src_depths,
                     src_cams: list[MVSCamera], vthresh: int = 2,
                     dist_thresh: float = 1.0,
                     rel_depth_thresh: float = 0.01,
                     device: torch.device | str = "cuda"):
    """Cross-view consistency mask, on `device` (the card unless the caller
    asks for the CPU).

    Args:
      ref_depth: [H, W] (0 = invalid); src_depths: [V, H, W] (arrays or
        tensors).
    Returns ([H, W] bool mask, [H, W] int consistent-view count).
    """
    device = torch.device(device)
    ref_depth = _as_f32(ref_depth, device)
    src_depths = _as_f32(src_depths, device)
    H, W = ref_depth.shape
    Er, Kr = _cam_arrays(ref_cam, device)
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device) + 0.5,
        torch.arange(W, dtype=torch.float32, device=device) + 0.5,
        indexing="ij")
    rays = _pixel_rays(torch.linalg.inv(Kr), H, W)
    pc = [rays[i] * ref_depth for i in range(3)]        # ref-cam points
    world = _mat(torch.linalg.inv(Er), pc + [1.0])      # 4 planes
    one = torch.ones_like(ref_depth)

    count = torch.zeros((H, W), dtype=torch.int32, device=device)
    for v, cam in enumerate(src_cams):
        Es, Ks = _cam_arrays(cam, device)
        ps = _mat(Es, world)[:3]
        z_src = ps[2]
        u = Ks[0, 0] * ps[0] / torch.clamp(z_src, min=1e-6) + Ks[0, 2] - 0.5
        w = Ks[1, 1] * ps[1] / torch.clamp(z_src, min=1e-6) + Ks[1, 2] - 0.5
        d_src, inb = _warp(src_depths[v][None], u[None], w[None])
        d_src, inb = d_src[0], inb[0]
        # unproject the sampled source depth, back into the reference view
        rays_s = _mat(torch.linalg.inv(Ks), [u + 0.5, w + 0.5, one])
        pcs = [r * d_src for r in rays_s]
        back = _mat(Er @ torch.linalg.inv(Es), pcs + [1.0])[:3]
        z_back = back[2]
        u_back = (Kr[0, 0] * back[0] / torch.clamp(z_back, min=1e-6)
                  + Kr[0, 2])
        v_back = (Kr[1, 1] * back[1] / torch.clamp(z_back, min=1e-6)
                  + Kr[1, 2])
        dist = torch.hypot(u_back - xs, v_back - ys)
        depth_ok = (torch.abs(ref_depth - z_back)
                    < rel_depth_thresh * torch.maximum(ref_depth, z_back))
        ok = (inb & (d_src > 1e-9) & (z_src > 1e-6)
              & (dist < dist_thresh) & depth_ok)
        count = count + ok.to(torch.int32)
    mask = (count >= vthresh) & (ref_depth > 1e-9)
    return mask, count

"""Mean squared distance to the 3 nearest neighbours (port of relightable3dgaussian_tpu/ops/knn.py).

The scale initialisation of `create_from_pcd`. As in the JAX package: exact
brute force for N <= 4·KNN_WINDOW; above that, points are sorted by their 30-bit
Morton code (normalised to the bounding box) and each point takes its 3
nearest among the ±KNN_WINDOW neighbours in that order, an approximation of the
same class as simple-knn's boxes.
"""
from __future__ import annotations

import torch

_BIG = 1e10
KNN_WINDOW = 32   # neighbours searched on each side in Morton order


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v (int64) so 2 zeros sit between each bit;
    the uint32 products of the JAX package, masked to 32 bits."""
    m = 0xFFFFFFFF
    v = ((v * 0x00010001) & m) & 0xFF0000FF
    v = ((v * 0x00000101) & m) & 0x0F00F00F
    v = ((v * 0x00000011) & m) & 0xC30C30C3
    v = ((v * 0x00000005) & m) & 0x49249249
    return v


def morton_codes(points: torch.Tensor, lo: torch.Tensor | None = None,
                 hi: torch.Tensor | None = None) -> torch.Tensor:
    """[N] 30-bit Morton codes (int64) of [N, 3] points in the box [lo, hi]
    (their own bbox by default)."""
    lo = points.min(0).values if lo is None else lo
    hi = points.max(0).values if hi is None else hi
    x = torch.clamp((points - lo) / torch.clamp(hi - lo, min=1e-9), 0.0, 1.0)
    q = torch.clamp((x * 1024.0).to(torch.int64), max=1023)
    return ((_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2]))


def mean_sq_dist_to_3nn(points: torch.Tensor) -> torch.Tensor:
    """[N] mean of the squared distances to each point's 3 nearest
    neighbours (exact for N <= 4·KNN_WINDOW, Morton-window approximate
    above)."""
    window = KNN_WINDOW
    n = points.shape[0]
    if n < 2:
        return torch.ones((n,), dtype=points.dtype, device=points.device)
    k = min(3, n - 1)
    if n <= 4 * window:
        d2 = ((points[:, None] - points[None, :]) ** 2).sum(-1)
        d2 = d2.masked_fill(torch.eye(n, dtype=torch.bool,
                                      device=points.device), _BIG)
        return torch.topk(d2, k, dim=-1, largest=False).values.mean(-1)

    order = torch.argsort(morton_codes(points), stable=True)
    sorted_pts = points[order]
    offs = torch.cat([torch.arange(-window, 0), torch.arange(1, window + 1)]
                     ).to(points.device)
    idx = torch.arange(n, device=points.device)[:, None] + offs[None, :]
    valid = (idx >= 0) & (idx < n)
    idx = torch.clamp(idx, 0, n - 1)
    d2 = ((sorted_pts[:, None] - sorted_pts[idx]) ** 2).sum(-1)   # [N, 2w]
    d2 = torch.where(valid, d2, _BIG)
    mean3 = torch.topk(d2, 3, dim=-1, largest=False).values.mean(-1)
    return torch.empty_like(mean3).index_copy_(0, order, mean3)

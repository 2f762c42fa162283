"""Frozen copy of the port's plain visibility tracer (`ops/ray_trace.py`,
with `morton_codes` of `ops/knn.py`), for the benchmark's plain reference,
in the dtype of its inputs (the port builds its records in float32).

It imports nothing of the port; a change to the port does not reach it.

Per ray, T = Π(1 − α) over the gaussians of every cluster whose AABB the
ray slab-hits, each α at the gaussian's maximum response along the ray;
visibility = T where T ≥ 0.9, else 0. Rays start at o + 0.05·d; clusters
are CLUSTER_SIZE gaussians in Morton order of their centres, boxed by their
3σ boxes; a gaussian is tested when opacity ≥ 1/255, n·d ≤ 0 and t ≥ 0.01,
α = min(opacity · e^power, 0.9999).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .quaternions import quaternion_to_rotmat

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


CLUSTER_SIZE = 32   # gaussians per cluster AABB
SUPER_SIZE = 32     # clusters per super AABB
RECORD = 16         # floats per gaussian record: g(3), W(9, row-major), op, n(3)
RAY_OFFSET = 0.05   # rays start at o + RAY_OFFSET · d
T_MIN = 0.9         # visibility = T where T >= T_MIN, else 0
RAY_CHUNK = 64      # rays per step (a [64, P] pair block)


class GaussianBVH(NamedTuple):
    """Morton-ordered gaussians in clusters, with two levels of AABBs."""
    order: torch.Tensor        # [P] int64 sorted gaussian indices
    records: torch.Tensor      # [C·CLUSTER_SIZE, RECORD] sorted; pad rows zero
    cluster_lo: torch.Tensor   # [C, 3] (+inf where empty)
    cluster_hi: torch.Tensor   # [C, 3] (-inf where empty)
    super_lo: torch.Tensor     # [ceil(C / SUPER_SIZE), 3]
    super_hi: torch.Tensor


def _group_boxes(lo: torch.Tensor, hi: torch.Tensor, size: int):
    """AABBs over groups of `size` consecutive boxes, padding with empty
    (+inf, -inf) boxes."""
    pad = (-lo.shape[0]) % size
    if pad:
        lo = torch.cat([lo, lo.new_full((pad, 3), float("inf"))])
        hi = torch.cat([hi, hi.new_full((pad, 3), float("-inf"))])
    return (lo.reshape(-1, size, 3).amin(1), hi.reshape(-1, size, 3).amax(1))


@torch.no_grad()
def build_bvh(xyz: torch.Tensor, scaling: torch.Tensor,
              rotation: torch.Tensor, opacity: torch.Tensor,
              normal: torch.Tensor) -> GaussianBVH:
    """Sort gaussians (activated scales [P, 3], unit quaternions [P, 4],
    opacities [P], normals [P, 3]) by Morton code and build the clusters."""
    P = xyz.shape[0]
    R = quaternion_to_rotmat(rotation)
    # AABB half-extent per axis: Σ_j |R_ij| 3 s_j, the 3σ ellipsoid's box.
    half = 3.0 * (R.abs() @ scaling[..., None])[..., 0]
    # The order from the centres in float32, as the program holds them: a
    # float64 code could bin a point across a boundary into another cluster.
    order = torch.argsort(morton_codes(xyz.float()), stable=True)
    pad = (-P) % CLUSTER_SIZE
    inf = xyz.new_full((pad, 3), float("inf"))
    lo = torch.cat([(xyz - half)[order], inf])
    hi = torch.cat([(xyz + half)[order], -inf])
    cluster_lo, cluster_hi = _group_boxes(lo, hi, CLUSTER_SIZE)
    super_lo, super_hi = _group_boxes(cluster_lo, cluster_hi, SUPER_SIZE)

    # W = diag(1/s) Rᵀ: W[i, j] = R[j, i] / s_i
    W = R.transpose(-1, -2) / torch.clamp(scaling, min=1e-8)[..., :, None]
    rec = torch.cat([xyz, W.reshape(P, 9), opacity[:, None], normal], dim=1)
    records = torch.cat([rec[order],
                         rec.new_zeros((pad, RECORD))]).contiguous()
    return GaussianBVH(order=order, records=records, cluster_lo=cluster_lo,
                       cluster_hi=cluster_hi, super_lo=super_lo,
                       super_hi=super_hi)


def safe_inverse(d: torch.Tensor) -> torch.Tensor:
    """1 / d with |d| < 1e-12 taken as ±1e-12 (the sign of d, + at 0)."""
    tiny = torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype)
    return 1.0 / torch.where(d.abs() < 1e-12, tiny, d)


def slab_hit(lo: torch.Tensor, hi: torch.Tensor, o: torch.Tensor,
             inv_d: torch.Tensor) -> torch.Tensor:
    """[R, M] slab test of rays o, inv_d [R, 3] against boxes lo, hi [M, 3]:
    the ray's t > 0 part meets the box, and the box is not empty."""
    tmin = torch.full((o.shape[0], lo.shape[0]), float("-inf"),
                      dtype=o.dtype, device=o.device)
    tmax = torch.full_like(tmin, float("inf"))
    for ax in range(3):
        t0 = (lo[None, :, ax] - o[:, None, ax]) * inv_d[:, None, ax]
        t1 = (hi[None, :, ax] - o[:, None, ax]) * inv_d[:, None, ax]
        tmin = torch.maximum(tmin, torch.minimum(t0, t1))
        tmax = torch.minimum(tmax, torch.maximum(t0, t1))
    return (tmax > 0.0) & (tmax >= tmin) & (lo <= hi).all(-1)[None]


def pair_one_minus_alpha(records: torch.Tensor, o: torch.Tensor,
                         d: torch.Tensor) -> torch.Tensor:
    """[R, N] 1 − α of every (ray, gaussian record) pair (records [N, 16],
    rays o, d [R, 3]), 1 where the pair is not tested."""
    rec = records.T[:, None, :]                                  # [16, 1, N]
    dg = [rec[a] - o[:, a, None] for a in range(3)]               # g − o
    dd = [d[:, a, None] for a in range(3)]
    u = [sum(rec[3 + 3 * i + a] * dg[a] for a in range(3)) for i in range(3)]
    v = [sum(rec[3 + 3 * i + a] * dd[a] for a in range(3)) for i in range(3)]
    vv = torch.clamp(v[0] * v[0] + v[1] * v[1] + v[2] * v[2], min=1e-12)
    t = (u[0] * v[0] + u[1] * v[1] + u[2] * v[2]) / vv
    r = [u[i] - t * v[i] for i in range(3)]
    power = -0.5 * (r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
    op = rec[12]
    nd = rec[13] * dd[0] + rec[14] * dd[1] + rec[15] * dd[2]
    ok = (op >= 1.0 / 255.0) & (nd <= 0.0) & (t >= 0.01)
    alpha = torch.clamp(op * torch.exp(power), max=0.9999)
    return torch.where(ok, 1.0 - alpha, 1.0)


def trace_transmittance_plain(bvh: GaussianBVH, o: torch.Tensor,
                              d: torch.Tensor) -> torch.Tensor:
    """[R] transmittance of rays that already start at their offset origin,
    by the rule above in torch ops, RAY_CHUNK rays at a time: a [R_c, C]
    cluster slab mask expanded to the clusters' gaussians, a masked pair
    test and a product. O(R·P) work: for tests and the card's check of K3."""
    inv_d = safe_inverse(d)
    out = []
    for i in range(0, o.shape[0], RAY_CHUNK):
        oc, dc = o[i:i + RAY_CHUNK], d[i:i + RAY_CHUNK]
        hit = slab_hit(bvh.cluster_lo, bvh.cluster_hi, oc, inv_d[i:i + RAY_CHUNK])
        mask = hit.repeat_interleave(CLUSTER_SIZE, dim=1)        # [R_c, N]
        one_m = pair_one_minus_alpha(bvh.records, oc, dc)
        out.append(torch.where(mask, one_m, 1.0).prod(-1))
    return torch.cat(out) if out else o.new_zeros((0,))


def trace_visibility_plain(bvh: GaussianBVH, rays_o: torch.Tensor,
                           rays_d: torch.Tensor) -> torch.Tensor:
    """[R, 1] visibility of rays [R, 3] by the plain version, on any device."""
    o = rays_o + RAY_OFFSET * rays_d
    T = trace_transmittance_plain(bvh, o, rays_d)
    return torch.where(T >= T_MIN, T, 0.0)[:, None]

"""Ray-traced visibility (port of relightable3dgaussian_tpu/ops/ray_trace.py).

The transmittance of rays through the gaussian cloud, as the CUDA reference's
`trace_bvh_opacity` computes it: per ray, T = Π(1 − α) over the gaussians it
passes, each α taken at the gaussian's maximum response along the ray, and
visibility = T where T ≥ 0.9, else 0. The product is order-independent, so
only the set of gaussians a ray tests matters. The rule, shared by the plain
version here and kernel K3 (ops/ray_trace_cuda.py, `csrc/ray_trace.cu`):

  * rays start at o + 0.05·d;
  * gaussians are sorted by the Morton code of their centres (stable) and
    grouped into clusters of CLUSTER_SIZE, each with the AABB of its members'
    3σ boxes; a ray tests every gaussian of each cluster whose AABB it
    slab-hits (t_max > 0), and no other;
  * the per-gaussian test, in whitened coordinates W = diag(1/s) Rᵀ:
    u = W(g − o), v = W d, t = u·v / max(v·v, 1e-12),
    power = −½|u − t v|², tested when opacity ≥ 1/255, n·d ≤ 0 and
    t ≥ 0.01, α = min(opacity · e^power, 0.9999).

This tests a superset of the gaussians the CUDA reference tests (each of its
own 3σ box) and a subset of what the JAX package's block rule tests; a
gaussian in a missed cluster lies more than 3σ from the ray (α < 0.0111·op).
The whitened form takes g − o before multiplying by W, in float32, which
keeps needle-thin gaussians far from the origin well conditioned. Super
AABBs over SUPER_SIZE clusters let K3 skip whole groups; they never change
the set (a hit cluster's box lies in its super's box). The TPU tracer's
quad feature tiles, candidate caps and their probes, and overflow counts
exist for its static shapes and are not carried over: this rule is exact by
construction. Its coherent ray order is carried over (`coherent_order`):
on the card, as on the TPU, it is what lets the rays a warp traces
together walk the same clusters. It changes no ray's T.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.quaternions import quaternion_to_rotmat
from .knn import morton_codes

CLUSTER_SIZE = 32   # gaussians per cluster AABB
SUPER_SIZE = 32     # clusters per super AABB
RECORD = 16         # floats per gaussian record: g(3), W(9, row-major), op, n(3)
RAY_OFFSET = 0.05   # rays start at o + RAY_OFFSET · d
T_MIN = 0.9         # visibility = T where T >= T_MIN, else 0
RAY_CHUNK = 256     # rays per step of the plain version
DIR_RES = 16        # octahedral direction bins per axis of the ray order


class GaussianBVH(NamedTuple):
    """Morton-ordered gaussians in clusters, with two levels of AABBs."""
    order: torch.Tensor        # [P] int64 sorted gaussian indices
    records: torch.Tensor      # [C·CLUSTER_SIZE, RECORD] sorted; pad rows zero
    cluster_lo: torch.Tensor   # [C, 3] (+inf where empty)
    cluster_hi: torch.Tensor   # [C, 3] (-inf where empty)
    super_lo: torch.Tensor     # [ceil(C / SUPER_SIZE), 3]
    super_hi: torch.Tensor


def inverse_covariance_packed(scaling: torch.Tensor,
                              rotation: torch.Tensor) -> torch.Tensor:
    """Packed (xx, xy, xz, yy, yz, zz) of Σ⁻¹ = R diag(1/s²) Rᵀ."""
    R = quaternion_to_rotmat(rotation)
    L = R / torch.clamp(scaling, min=1e-8)[..., None, :]
    M = L @ L.transpose(-1, -2)
    return torch.stack([M[..., 0, 0], M[..., 0, 1], M[..., 0, 2],
                        M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]], dim=-1)


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
    order = torch.argsort(morton_codes(xyz), stable=True)
    pad = (-P) % CLUSTER_SIZE
    inf = xyz.new_full((pad, 3), float("inf"))
    lo = torch.cat([(xyz - half)[order], inf])
    hi = torch.cat([(xyz + half)[order], -inf])
    cluster_lo, cluster_hi = _group_boxes(lo, hi, CLUSTER_SIZE)
    super_lo, super_hi = _group_boxes(cluster_lo, cluster_hi, SUPER_SIZE)

    # W = diag(1/s) Rᵀ: W[i, j] = R[j, i] / s_i
    W = R.transpose(-1, -2) / torch.clamp(scaling, min=1e-8)[..., :, None]
    rec = torch.cat([xyz, W.reshape(P, 9), opacity[:, None], normal], dim=1)
    records = torch.cat([rec[order].float(),
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


def direction_bins(d: torch.Tensor) -> torch.Tensor:
    """[R] octahedral-map bin in [0, DIR_RES²) (int64) of unit directions
    [R, 3]."""
    res = DIR_RES
    a = torch.clamp(d.abs().sum(-1), min=1e-12)
    u, v = d[:, 0] / a, d[:, 1] / a
    neg = d[:, 2] < 0
    u2 = torch.where(neg, (1.0 - v.abs()) * torch.sign(u), u)
    v2 = torch.where(neg, (1.0 - u.abs()) * torch.sign(v), v)
    iu = torch.clamp(((u2 * 0.5 + 0.5) * res).to(torch.int64), 0, res - 1)
    iv = torch.clamp(((v2 * 0.5 + 0.5) * res).to(torch.int64), 0, res - 1)
    return iu * res + iv


def coherent_key(bvh: GaussianBVH, o: torch.Tensor,
                 d: torch.Tensor) -> torch.Tensor:
    """[R] 32-bit sort key (int64) of rays from o along d: the direction bin
    in the high bits, the origin's Morton code in the cloud's box in the
    rest (the JAX package's ops/ray_trace.py::_coherent_order)."""
    morton_bits = 32 - 2 * (DIR_RES - 1).bit_length()
    code = morton_codes(o, lo=bvh.cluster_lo.amin(0), hi=bvh.cluster_hi.amax(0))
    return ((direction_bins(d) << morton_bits)
            | (code >> max(0, 30 - morton_bits)))


def coherent_order(bvh: GaussianBVH, o: torch.Tensor,
                   d: torch.Tensor) -> torch.Tensor:
    """[R] permutation (int64) that sorts rays by `coherent_key`: rays of
    one direction bin together, and inside it by origin along the Morton
    curve, so neighbouring rays pass the same clusters."""
    # the key less 2^31 fits int32, which sorts faster than int64
    key = (coherent_key(bvh, o, d) - (1 << 31)).to(torch.int32)
    return torch.argsort(key)


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
    o = rays_o.float() + RAY_OFFSET * rays_d.float()
    T = trace_transmittance_plain(bvh, o, rays_d.float())
    return torch.where(T >= T_MIN, T, 0.0)[:, None]


def trace_visibility(bvh: GaussianBVH, rays_o: torch.Tensor,
                     rays_d: torch.Tensor) -> torch.Tensor:
    """[R, 1] visibility of rays from origins [R, 3] along unit directions
    [R, 3]: the plain version on CPU tensors, kernel K3 on CUDA tensors."""
    from . import ray_trace_cuda
    tensors = (rays_o, rays_d, *bvh)
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return trace_visibility_plain(bvh, rays_o, rays_d)
    if devices != {"cuda"}:
        raise ValueError(f"trace_visibility: inputs on {sorted(devices)}; "
                         "expected all on CPU or all on CUDA")
    o = rays_o.float() + RAY_OFFSET * rays_d.float()
    T = ray_trace_cuda.trace_k3(bvh, o.contiguous(),
                                rays_d.float().contiguous())
    return torch.where(T >= T_MIN, T, 0.0)[:, None]

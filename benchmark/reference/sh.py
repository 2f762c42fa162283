"""Frozen copy of the port's `utils/sh.py`, for the benchmark's plain reference.

It imports nothing of the port; a change to the port does not reach it.

Real spherical harmonics (port of relightable3dgaussian_tpu/utils/sh.py).

`eval_sh_basis`, `eval_sh`, `rgb_to_sh` and `rotation_between_z`, with the
same basis order and 3DGS sign convention (band-1 terms are [-y, z, -x]
scaled by C1).
"""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def eval_sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit directions → [..., (deg+1)**2] basis values."""
    assert 0 <= deg <= 4
    out = [torch.full_like(dirs[..., 0], C0)]
    if deg > 0:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        out += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            out += [
                C2[0] * xy,
                C2[1] * yz,
                C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz,
                C2[4] * (xx - yy),
            ]
            if deg > 2:
                out += [
                    C3[0] * y * (3 * xx - yy),
                    C3[1] * xy * z,
                    C3[2] * y * (4 * zz - xx - yy),
                    C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                    C3[4] * x * (4 * zz - xx - yy),
                    C3[5] * z * (xx - yy),
                    C3[6] * x * (xx - 3 * yy),
                ]
                if deg > 3:
                    out += [
                        C4[0] * xy * (xx - yy),
                        C4[1] * yz * (3 * xx - yy),
                        C4[2] * xy * (7 * zz - 1),
                        C4[3] * yz * (7 * zz - 3),
                        C4[4] * (zz * (35 * zz - 30) + 3),
                        C4[5] * xz * (7 * zz - 3),
                        C4[6] * (xx - yy) * (7 * zz - 1),
                        C4[7] * xz * (xx - 3 * yy),
                        C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
                    ]
    return torch.stack(out, dim=-1)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate an SH expansion: sh [..., C, K] (K >= (deg+1)**2) at dirs
    [..., 3] → [..., C]."""
    ncoef = (deg + 1) ** 2
    assert sh.shape[-1] >= ncoef
    basis = eval_sh_basis(deg, dirs)
    return torch.einsum("...k,...ck->...c", basis, sh[..., :ncoef])


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """Invert the DC-band shift: color 0.5 maps to coefficient 0."""
    return (rgb - 0.5) / C0


def rotation_between_z(vec: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit vectors → [..., 3, 3] rotations R with R @ +z == vec
    (Rodrigues' special case), -I where vec is -z."""
    v1, v2 = -vec[..., 1], vec[..., 0]
    cos_p_1 = torch.clamp(vec[..., 2] + 1.0, min=1e-7)
    v11, v22, v12 = v1 * v1, v2 * v2, v1 * v2
    rows = torch.stack([
        torch.stack([1 - v22 / cos_p_1, v12 / cos_p_1, v2], dim=-1),
        torch.stack([v12 / cos_p_1, 1 - v11 / cos_p_1, -v1], dim=-1),
        torch.stack([-v2, v1, 1 + (-v22 - v11) / cos_p_1], dim=-1),
    ], dim=-2)
    antipodal = (vec[..., 2] + 1.0) <= 0.0
    neg_eye = -torch.eye(3, dtype=rows.dtype, device=rows.device)
    return torch.where(antipodal[..., None, None], neg_eye, rows)

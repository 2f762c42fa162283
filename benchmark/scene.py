"""The benchmark's inputs, made on the device from the seed: a surface
splat of a fixed object, NeRF-synthetic's camera layout and ground-truth
RGBA images of the object.

The object is a fixed set of spheres (`SPHERES`) inside NeRF-synthetic's
extent, the same for every seed, so every seed asks the same work of the
program; the seed draws where on the surfaces the points lie, their spin
about the normal, opacities, colours and SH detail, and the camera order.
A point is what a trained splat is: a flat gaussian on the surface, its
normal along the surface normal, its two tangent scales from the mean
squared distance to its 3 nearest neighbours and its normal scale a tenth
of that, opacity uniform from low to high. The ground truth is the object
itself ray-cast analytically (Lambert under a fixed light), never a
render of the program, so the program and the reference get the same
images. Cameras lie on the upper hemisphere of radius `camera_radius`,
looking at the origin with +z up, as NeRF-synthetic's do.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference.quaternions import rotmat_to_quaternion
from .reference.sh import rgb_to_sh

# (centre xyz, radius, albedo rgb): one body, six around it, one on top.
SPHERES = (
    ((0.0, 0.0, 0.0), 0.55, (0.80, 0.62, 0.45)),
    *(((0.85 * math.cos(k * math.pi / 3), 0.85 * math.sin(k * math.pi / 3),
        0.2 if k % 2 else -0.2), 0.3,
       (0.25 + 0.1 * k, 0.75 - 0.08 * k, 0.35 + 0.05 * k)) for k in range(6)),
    ((0.0, 0.0, 0.75), 0.25, (0.9, 0.9, 0.85)),
)
LIGHT_DIR = (0.3, -0.4, 0.866)
NORMAL_SCALE = 0.1          # the normal axis' scale over the tangent scales
OPACITY_RANGE = (0.05, 0.99)
SH_REST_STD = 0.05
KNN_WINDOW = 32


def sphere_counts(P: int) -> list[int]:
    """Points per sphere, in proportion to its area; they sum to P."""
    areas = np.array([r * r for _, r, _ in SPHERES])
    counts = np.floor(P * areas / areas.sum()).astype(int)
    counts[0] += P - counts.sum()
    return counts.tolist()


def _mean_sq_dist_3nn(points: torch.Tensor) -> torch.Tensor:
    """[N] mean squared distance to the 3 nearest among the ±KNN_WINDOW
    neighbours in Morton order (the scale rule of 3DGS's simple-knn)."""
    lo, hi = points.min(0).values, points.max(0).values
    q = torch.clamp(((points - lo) / torch.clamp(hi - lo, min=1e-9) * 1024.0)
                    .to(torch.int64), 0, 1023)

    def spread(v):
        m = 0xFFFFFFFF
        v = ((v * 0x00010001) & m) & 0xFF0000FF
        v = ((v * 0x00000101) & m) & 0x0F00F00F
        v = ((v * 0x00000011) & m) & 0xC30C30C3
        return ((v * 0x00000005) & m) & 0x49249249

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    order = torch.argsort(code, stable=True)
    pts = points[order]
    n = pts.shape[0]
    offs = torch.cat([torch.arange(-KNN_WINDOW, 0),
                      torch.arange(1, KNN_WINDOW + 1)]).to(points.device)
    idx = torch.arange(n, device=points.device)[:, None] + offs[None, :]
    valid = (idx >= 0) & (idx < n)
    d2 = ((pts[:, None] - pts[idx.clamp(0, n - 1)]) ** 2).sum(-1)
    d2 = torch.where(valid, d2, 1e10)
    mean3 = torch.topk(d2, 3, dim=-1, largest=False).values.mean(-1)
    return torch.empty_like(mean3).index_copy_(0, order, mean3)


def make_points(P: int, gen: torch.Generator, device) -> dict:
    """The raw stage-1 fields of P surface gaussians, float32 on `device`."""
    centres, normals, albedo = [], [], []
    for (c, r, rgb), n in zip(SPHERES, sphere_counts(P)):
        d = torch.randn((n, 3), generator=gen, device=device)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        centres.append(torch.tensor(c, device=device) + r * d)
        normals.append(d)
        albedo.append(torch.tensor(rgb, device=device).expand(n, 3))
    xyz, nrm, col = (torch.cat(x) for x in (centres, normals, albedo))
    # Tangent frame: any perpendicular, spun about the normal by the seed.
    helper = torch.where(nrm[:, :1].abs() < 0.9,
                         torch.tensor([1.0, 0.0, 0.0], device=device),
                         torch.tensor([0.0, 1.0, 0.0], device=device))
    t1 = torch.linalg.cross(nrm, helper)
    t1 = t1 / torch.linalg.norm(t1, dim=-1, keepdim=True)
    t2 = torch.linalg.cross(nrm, t1)
    spin = 2 * math.pi * torch.rand((P, 1), generator=gen, device=device)
    a = torch.cos(spin) * t1 + torch.sin(spin) * t2
    b = torch.linalg.cross(nrm, a)
    rot = rotmat_to_quaternion(torch.stack([a, b, nrm], dim=-1))
    s = torch.sqrt(torch.clamp(_mean_sq_dist_3nn(xyz), min=1e-7))
    scales = torch.stack([s, s, NORMAL_SCALE * s], dim=-1)
    lo, hi = OPACITY_RANGE
    op = lo + (hi - lo) * torch.rand((P, 1), generator=gen, device=device)
    col = torch.clamp(col * (0.85 + 0.3 * torch.rand((P, 3), generator=gen,
                                                     device=device)), 0, 1)
    return {
        "xyz": xyz.contiguous(),
        "normal": nrm.contiguous(),
        "shs_dc": rgb_to_sh(col)[:, None].contiguous(),
        "shs_rest": SH_REST_STD * torch.randn((P, 15, 3), generator=gen,
                                              device=device),
        "scaling": torch.log(scales),
        "rotation": rot.contiguous(),
        "opacity": torch.log(op / (1 - op)),
    }


def look_at(campos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(R, T) in the port's COLMAP convention (R the camera-to-world
    rotation, T the world-to-camera translation) of a camera at `campos`
    looking at the origin, +z up, OpenCV axes (x right, y down, z ahead)."""
    f = -campos / np.linalg.norm(campos)
    right = np.cross(f, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(f, right)
    R = np.stack([right, down, f], axis=1)          # camera → world
    return R, -R.T @ campos


def hemisphere_cameras(n: int, radius: float) -> list[tuple]:
    """n cameras on a Fibonacci lattice of the upper hemisphere (elevations
    from ~3° to ~84°), the same for every seed."""
    golden = math.pi * (3.0 - math.sqrt(5.0))
    cams = []
    for i in range(n):
        z = 0.05 + 0.9 * (i + 0.5) / n
        r = math.sqrt(1 - z * z)
        cams.append(look_at(radius * np.array(
            [r * math.cos(golden * i), r * math.sin(golden * i), z])))
    return cams


def orbit_cameras(n: int, radius: float, elevation_deg: float) -> list[tuple]:
    """n cameras evenly around +z at one elevation (NeRF-synthetic's test
    orbit)."""
    e = math.radians(elevation_deg)
    return [look_at(radius * np.array(
        [math.cos(e) * math.cos(2 * math.pi * i / n),
         math.cos(e) * math.sin(2 * math.pi * i / n), math.sin(e)]))
        for i in range(n)]


def extent(cams: list[tuple]) -> float:
    """1.1 x the largest distance of a camera centre from their mean (the
    nerf++ normalisation that sets the position learning rate's scale)."""
    centres = np.stack([-R @ T for R, T in cams])
    return float(np.linalg.norm(centres - centres.mean(0), axis=-1).max() * 1.1)


def ground_truth(cam: tuple, width: int, height: int, fovx: float,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """([3, H, W] RGB, [1, H, W] mask) of the spheres seen from `cam`:
    the nearest hit of each pixel's ray, Lambert under LIGHT_DIR with a
    fifth ambient, black where no sphere is hit."""
    R, T = cam
    f = width / (2 * math.tan(fovx / 2))
    u = torch.arange(width, device=device, dtype=torch.float32)
    v = torch.arange(height, device=device, dtype=torch.float32)
    x = ((u[None, :] - width / 2) / f).expand(height, width)
    y = ((v[:, None] - height / 2) / f).expand(height, width)
    d = torch.stack([x, y, torch.ones_like(x)], -1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    d = d @ torch.tensor(R, dtype=torch.float32, device=device).T
    o = torch.tensor(-R @ T, dtype=torch.float32, device=device)
    best = torch.full((height, width), float("inf"), device=device)
    rgb = torch.zeros((height, width, 3), device=device)
    light = torch.tensor(LIGHT_DIR, device=device)
    light = light / torch.linalg.norm(light)
    for c, r, col in SPHERES:
        oc = o - torch.tensor(c, device=device)
        b = (d * oc).sum(-1)
        disc = b * b - (oc * oc).sum() + r * r
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        hit = (disc > 0) & (t > 0) & (t < best)
        n = (o + t[..., None] * d - torch.tensor(c, device=device)) / r
        shade = 0.2 + 0.8 * torch.clamp((n * light).sum(-1, keepdim=True), min=0)
        rgb = torch.where(hit[..., None],
                          shade * torch.tensor(col, device=device), rgb)
        best = torch.where(hit, t, best)
    mask = torch.isfinite(best).to(torch.float32)[None]
    return rgb.permute(2, 0, 1).contiguous(), mask


def env_map(height: int, gen: torch.Generator, device) -> torch.Tensor:
    """[H, 2H, 3] linear HDR sky: a blue-to-white gradient over a brown
    ground, a sun of radiance 50 at a seeded azimuth and 40° elevation, and
    a seeded low-contrast cloud pattern."""
    W = 2 * height
    phi = (torch.arange(height, device=device) + 0.5) / height * math.pi
    theta = (torch.arange(W, device=device) + 0.5) / W * 2 * math.pi - math.pi
    z = torch.cos(phi)[:, None, None].expand(height, W, 1)
    sky = torch.tensor([0.35, 0.55, 1.0], device=device) * (0.6 + 0.4 * z) + 0.4
    ground = torch.tensor([0.25, 0.2, 0.15], device=device).expand(height, W, 3)
    img = torch.where(z > 0, sky.expand(height, W, 3), ground)
    az = float(2 * math.pi * torch.rand((), generator=gen, device=device))
    el = math.radians(40.0)
    sun = torch.tensor([math.cos(el) * math.cos(az), math.cos(el) * math.sin(az),
                        math.sin(el)], device=device)
    dirs = torch.stack([torch.sin(phi)[:, None] * torch.cos(theta)[None],
                        torch.sin(phi)[:, None] * torch.sin(theta)[None],
                        torch.cos(phi)[:, None].expand(height, W)], -1)
    img = img + 50.0 * ((dirs @ sun) > math.cos(math.radians(2.0)))[..., None]
    clouds = torch.rand((height // 16, W // 16, 1), generator=gen, device=device)
    clouds = torch.nn.functional.interpolate(
        clouds.permute(2, 0, 1)[None], size=(height, W), mode="bilinear",
        align_corners=False)[0].permute(1, 2, 0)
    return (img * (0.8 + 0.4 * clouds)).contiguous()


def make_pbr(P: int, fields: dict, gen: torch.Generator, device) -> dict:
    """Raw PBR fields of a finished stage-2 model: base colour about the
    points' own colour, roughness spread over its range, small local-light
    and visibility SH; float32 on `device`."""
    from .reference.sh import C0
    rgb = torch.clamp(fields["shs_dc"][:, 0] * C0 + 0.5, 0.031, 0.79)
    base = torch.logit((rgb - 0.03) / 0.77, eps=1e-4)
    return {
        "base_color": base.contiguous(),
        "roughness": torch.randn((P, 1), generator=gen, device=device),
        "incidents_dc": 0.1 * torch.rand((P, 1, 3), generator=gen,
                                         device=device),
        "incidents_rest": 0.02 * torch.randn((P, 15, 3), generator=gen,
                                             device=device),
        "visibility_dc": 0.5 * torch.randn((P, 1, 1), generator=gen,
                                           device=device),
        "visibility_rest": 0.05 * torch.randn((P, 15, 1), generator=gen,
                                              device=device),
    }

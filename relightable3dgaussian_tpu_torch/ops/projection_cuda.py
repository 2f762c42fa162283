"""The projection on the card: kernel K7, one forward and one backward
launch a view (`csrc/projection.cu`).

It replaces no TPU kernel: the JAX package leaves `preprocess` to XLA. The
plain version is `ops/projection.py::preprocess_plain`, which CPU tensors
take; `preprocess` sends CUDA tensors to `project`, which launches the
kernels or raises. Nothing falls back. The backward's formulas are written
out in plain PyTorch as `ops/projection.py::projection_backward_plain`.

`project` runs `ProjectFunction`, a `torch.autograd.Function` whose forward
is one launch and whose backward is one launch: it recomputes the forward's
intermediates from the inputs, so the graph keeps the inputs alone. The
kernel takes what the caller passes, all visible in the arguments: the SH
rows at the active degree or the caller's colours (which pass through, as
their gradient does), scales and rotations or a precomputed covariance
(packed [P, 6] or the full [P, 3, 3]), the opacity's alpha-aware tile rect
or none. Float32 only, as every caller on the card renders. The gradient of
`mean2d_offset` is mean2d's, returned with no launch.

The tracer's counters: `k7.launches`, `k7.bwd_launches`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

KERNEL = "projection"
MAX_SH_DEGREE = 3
_FWD = _build.Entry(KERNEL, "r3dg_projection_fwd",
                    "ppppppp ppppp q iiiiiiii f pppppppp", "K7 forward",
                    ("k7.launches",))
_BWD = _build.Entry(KERNEL, "r3dg_projection_bwd",
                    "ppppp ppppp pppp q iiiii f ppppp", "K7 backward",
                    ("k7.bwd_launches",))


class Layout(NamedTuple):
    """A launch's sizes: P gaussians; K SH coefficients a row at `deg`
    (-1: colours given); `cov_kind` 0 (scales and rotations), 6 (packed) or
    9 (full); the image and its tile grid; the scale modifier."""
    P: int
    K: int
    deg: int
    cov_kind: int
    width: int
    height: int
    tile: int
    tiles_x: int
    tiles_y: int
    scale_modifier: float


def check_inputs(means3d, scales, rotations, shs, cov3d, offset, opacity,
                 colors, cam: tuple, cfg) -> Layout:
    """Raises ValueError unless every tensor the kernel reads is contiguous,
    float32, on the means' device and of its shape,
    the SH degree is 0 to 3 with enough coefficients a row, and no camera
    tensor needs a gradient: the only check before a launch. Returns the
    launch's layout."""
    P = means3d.shape[0]
    expect = {"means3d": (means3d, (P, 3))}
    cov_kind = 0
    if cov3d is None:
        expect["scales"] = (scales, (P, 3))
        expect["rotations"] = (rotations, (P, 4))
    else:
        cov_kind = 6 if cov3d.dim() == 2 else 9
        expect["cov3d_precomp"] = (cov3d, (P, 6) if cov_kind == 6
                                   else (P, 3, 3))
    deg, K = -1, 0
    if colors is None:
        deg = cfg.sh_degree
        if not 0 <= deg <= MAX_SH_DEGREE:
            raise ValueError(f"K7: SH degree {deg}, the kernel takes 0 to "
                             f"{MAX_SH_DEGREE}")
        if shs is None:
            raise ValueError("K7: neither shs nor colors given")
        K = shs.shape[1] if shs.dim() == 3 else 0
        if K < (deg + 1) ** 2:
            raise ValueError(f"K7 shs: got {tuple(shs.shape)}, expected "
                             f"[{P}, >= {(deg + 1) ** 2}, 3] at degree {deg}")
        expect["shs"] = (shs, (P, K, 3))
    else:
        expect["colors"] = (colors, (P, 3))
    if offset is not None:
        expect["mean2d_offset"] = (offset, (P, 2))
    if opacity is not None:
        expect["opacity"] = (opacity, (P,))
    for name, t, shape in zip(("world_view", "full_proj", "campos", "focal",
                               "tan_fov"), cam,
                              ((4, 4), (4, 4), (3,), (2,), (2,))):
        if t.requires_grad:
            raise ValueError(f"K7 camera {name}: requires grad; the kernel "
                             "gives the camera no gradient")
        expect[name] = (t, shape)
    _build.check_tensors("K7", means3d.device, expect)
    return Layout(P, K, deg, cov_kind, cfg.width, cfg.height, cfg.tile,
                  cfg.tiles_x, cfg.tiles_y, float(cfg.scale_modifier))


class ProjectFunction(torch.autograd.Function):
    """(means3d, scales, rotations, shs, cov3d_precomp, mean2d_offset,
    opacity, camera tensors, layout) → (mean2d, depth, conic, radius,
    rect_min, rect_max, tiles_touched[, rgb]), rgb where the layout's
    degree is 0 to 3; absent inputs are None. Saves the inputs, nothing
    else."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, shs, cov3d, offset, opacity,
                cam, layout):
        ctx.save_for_backward(means3d, scales, rotations, shs, cov3d, *cam)
        ctx.layout = layout
        ctx.set_materialize_grads(False)
        outs = project_fwd(means3d, scales, rotations, shs, cov3d, offset,
                           opacity, cam, layout)
        ctx.mark_non_differentiable(*outs[3:7])
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_mean2d, g_depth, g_conic, *rest):
        g_rgb = rest[4] if len(rest) > 4 else None
        needs = ctx.needs_input_grad
        g_offset = g_mean2d if needs[5] else None
        wanted = needs[:5]
        if not any(wanted) or all(g is None for g in (g_mean2d, g_depth,
                                                      g_conic, g_rgb)):
            return None, None, None, None, None, g_offset, None, None, None
        means3d, scales, rotations, shs, cov3d, *cam = ctx.saved_tensors
        grads = project_bwd(means3d, scales, rotations, shs, cov3d, cam,
                            g_mean2d, g_depth, g_conic, g_rgb, ctx.layout,
                            wanted)
        return (*grads, g_offset, None, None, None)


def project(means3d, scales, rotations, shs, cam, cfg, mean2d_offset=None,
            opacity=None, colors=None, cov3d_precomp=None) -> tuple:
    """`preprocess` on the card: the fields of `Preprocessed` in its order,
    from K7, differentiable in the means, scales, rotations, SH rows,
    covariance, offset and colours given. Tensors on one CUDA device."""
    def c(t):
        return None if t is None else t.contiguous()

    cams = tuple(t.contiguous() for t in (cam.world_view, cam.full_proj,
                                          cam.campos, cam.focal, cam.tan_fov))
    if cov3d_precomp is not None:
        scales = rotations = None
    if colors is not None:
        shs = None
    means3d, scales, rotations, shs = (c(means3d), c(scales), c(rotations),
                                       c(shs))
    cov3d, offset, opacity = c(cov3d_precomp), c(mean2d_offset), c(opacity)
    layout = check_inputs(means3d, scales, rotations, shs, cov3d, offset,
                          opacity, colors, cams, cfg)
    outs = ProjectFunction.apply(means3d, scales, rotations, shs, cov3d,
                                 offset, opacity, cams, layout)
    mean2d, depth, conic, radius, rect_min, rect_max, tiles = outs[:7]
    rgb = colors if colors is not None else outs[7]
    return mean2d, depth, conic, radius, rgb, rect_min, rect_max, tiles


def project_fwd(means3d, scales, rotations, shs, cov3d, offset, opacity,
                cam: tuple, layout: Layout) -> tuple:
    """The forward kernel: (mean2d, depth, conic, radius, rect_min,
    rect_max, tiles_touched[, rgb])."""
    P, dev = layout.P, means3d.device
    f = dict(dtype=torch.float32, device=dev)
    i = dict(dtype=torch.int32, device=dev)
    outs = (torch.empty((P, 2), **f), torch.empty((P,), **f),
            torch.empty((P, 3), **f), torch.empty((P,), **i),
            torch.empty((P, 2), **i), torch.empty((P, 2), **i),
            torch.empty((P,), **i))
    rgb = torch.empty((P, 3), **f) if layout.deg >= 0 else None
    if P > 0:
        _FWD(dev, means3d, scales, rotations, shs, cov3d, offset, opacity,
             *cam, P, layout.K, layout.deg, layout.cov_kind, layout.width,
             layout.height, layout.tile, layout.tiles_x, layout.tiles_y,
             layout.scale_modifier, outs[0], outs[1], outs[2], rgb,
             *outs[3:])
    return outs if rgb is None else (*outs, rgb)


def project_bwd(means3d, scales, rotations, shs, cov3d, cam, g_mean2d,
                g_depth, g_conic, g_rgb, layout: Layout,
                wanted=(True,) * 5) -> tuple:
    """The backward kernel: the gradients of (means3d, scales, rotations,
    shs, cov3d) from those of mean2d, depth, conic and rgb (None: zero);
    None where an input is absent or its gradient not `wanted`."""
    P, dev = layout.P, means3d.device
    g_in = [None if g is None else g.contiguous()
            for g in (g_mean2d, g_depth, g_conic, g_rgb)]
    shapes = ((P, 2), (P,), (P, 3), (P, 3))
    _build.check_tensors("K7 backward", dev, {
        name: (g, shape) for name, g, shape in zip(
            ("g_mean2d", "g_depth", "g_conic", "g_rgb"), g_in, shapes)
        if g is not None})
    outs = [torch.empty_like(t) if t is not None and w else None
            for t, w in zip((means3d, scales, rotations, shs, cov3d), wanted)]
    if P > 0:
        _BWD(dev, means3d, scales, rotations, shs, cov3d, *cam, *g_in, P,
             layout.K, layout.deg, layout.cov_kind, layout.width,
             layout.height, layout.scale_modifier, *outs)
    return tuple(outs)

"""What the kinds share: the seeded inputs, the program's and the
reference's cameras, the raster configuration, the profiler, the
reference walk that counts a view's pairs, and the control's precision."""
from __future__ import annotations

import contextlib
import gc
import math
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import torch

from .. import scene
from ..harness import phase

PBR_SHAPES = {"base_color": (3,), "roughness": (1,), "incidents_dc": (1, 3),
              "incidents_rest": (15, 3), "visibility_dc": (1, 1),
              "visibility_rest": (15, 1)}


@dataclass
class Inputs:
    fields: dict                 # raw stage-1 fields, float32, the seed's
    start: dict                  # every leaf as training starts (+ PBR, env)
    cams: list                   # (R, T) per view
    extent: float
    images: list = field(default_factory=list)   # (rgb, mask) per view
    env_raw: Any = None          # stage 2: the learnable env map's raw start


@dataclass
class State:
    ctx: Any
    inputs: Inputs
    opt: Any = None
    model: Any = None
    optimizer: Any = None
    env: Any = None
    env_optimizer: Any = None
    vis: Any = None
    views: Any = None
    split_gen: Any = None
    prog: dict = field(default_factory=dict)
    iterations: list = field(default_factory=list)
    check_views: list = field(default_factory=list)
    extra: dict = field(default_factory=dict)


class RefView(NamedTuple):
    cam: Any
    image: torch.Tensor
    image_mask: torch.Tensor


def fovs(c: dict) -> tuple[float, float]:
    fovx = c["camera_angle_x"]
    focal = c["width"] / (2 * math.tan(fovx / 2))
    return fovx, 2 * math.atan(c["height"] / (2 * focal))


def inputs(ctx, with_images: bool) -> Inputs:
    """The cell's inputs from the seed, on the device: the points, the
    training cameras (and their images), and for stage 2 the PBR fields'
    zero start and the env map's raw start (light_init x U[0, 1))."""
    c, dev = ctx.config, ctx.device
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    fields = scene.make_points(c["points"], gen, dev)
    cams = scene.hemisphere_cameras(c["train_views"], c["camera_radius"])
    s = Inputs(fields=fields, start=dict(fields), cams=cams,
               extent=scene.extent(cams))
    sync(dev)
    phase("points")
    if with_images:
        s.images = [scene.ground_truth(cam, c["width"], c["height"],
                                       c["camera_angle_x"], dev)
                    for cam in cams]
        sync(dev)
        phase("images")
    if c["stage"] == 2:
        P = c["points"]
        for k, shape in PBR_SHAPES.items():
            s.start[k] = torch.zeros((P,) + shape, device=dev)
        r = c["env_resolution"]
        s.env_raw = c["light_init"] * torch.rand((r, 2 * r, 3), generator=gen,
                                                 device=dev)
        s.start["env"] = s.env_raw
    return s


def program_cameras(ctx, cams) -> list:
    from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
    c = ctx.config
    fovx, fovy = fovs(c)
    return [make_camera_params(R, T, c["width"], c["height"], fovx=fovx,
                               fovy=fovy, device=ctx.device) for R, T in cams]


def reference_cameras(ctx, cams, dtype) -> list:
    """The reference's own cameras from the same (R, T), built as float32
    (as the program's are) and cast to `dtype`."""
    from ..reference.camera import make_camera_params
    c = ctx.config
    fovx, fovy = fovs(c)
    out = []
    for R, T in cams:
        cam = make_camera_params(R, T, c["width"], c["height"], fovx=fovx,
                                 fovy=fovy, device=ctx.device)
        out.append(type(cam)(*(x.to(dtype) for x in cam)))
    return out


def raster_config(c: dict):
    from ..reference.config import RasterConfig
    return RasterConfig(height=c["height"], width=c["width"],
                        sh_degree=c["sh_degree"],
                        white_background=c["white_background"])


def program_raster_config(c: dict):
    from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
    return RasterConfig(height=c["height"], width=c["width"],
                        sh_degree=c["sh_degree"],
                        white_background=c["white_background"])


def geometry(model) -> dict:
    """A copy of what the projection reads of the model: the walk's input."""
    with torch.no_grad():
        return {k: getattr(model, k).detach().clone()
                for k in ("xyz", "scaling", "rotation", "opacity")}


def walk_counts(st, geometry: dict, view: int) -> tuple[int, int, int]:
    """walk_counts_at from training camera `view`."""
    cams = st.extra.setdefault("walk_cams", {})
    if view not in cams:
        cams[view] = reference_cameras(st.ctx, [st.inputs.cams[view]],
                                       torch.float32)[0]
    return walk_counts_at(st, geometry, cams[view])


@torch.no_grad()
def walk_counts_at(st, geometry: dict, cam) -> tuple[int, int, int]:
    """(binned pairs, pixel-pair steps walked to each pixel's stop, pairs
    blended) of the reference's float32 walk over `geometry` (raw xyz,
    scaling, rotation, opacity) from `cam`: the pairs these inputs need,
    whatever walks them."""
    from ..reference import composite as RC
    from ..reference import render as RR
    cfg = raster_config(st.ctx.config)
    P = geometry["xyz"].shape[0]
    dev = geometry["xyz"].device
    op = torch.sigmoid(geometry["opacity"])
    prep, binning, _ = RR.prepare(
        geometry["xyz"], torch.exp(geometry["scaling"]),
        RR.act_rotation(geometry), op, torch.zeros((P, 16, 3), device=dev),
        torch.zeros((P, 0), device=dev), cam, cfg)
    ones = torch.ones((P, 1), device=dev)
    out = RC.composite(binning, prep.mean2d, prep.conic, op[:, 0], ones, cfg)
    walk = RC.walk_state(binning, prep.mean2d, prep.conic, op[:, 0], cfg)
    return (binning.num_rendered, int(walk.stop.to(torch.int64).sum()),
            int(out.n_contrib.to(torch.int64).sum()))


def stage2_train_width(opt) -> int:
    """Feature channels of the stage-2 train render under `opt`, as the
    port's render_neilf picks them from the losses' lambdas."""
    w = 3                                                   # pbr
    if opt.lambda_depth_var > 0:
        w += 1
    if (opt.lambda_normal_render_depth > 0 or opt.lambda_normal_smooth > 0
            or opt.lambda_normal_mvs_depth > 0 or opt.lambda_light_smooth > 0):
        w += 3
    if opt.lambda_base_color_smooth > 0:
        w += 3
    if opt.lambda_roughness_smooth > 0:
        w += 1
    if opt.lambda_light_smooth > 0:
        w += 3
    return w


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def fixed_heap() -> bool:
    """Fix this process's malloc thresholds (glibc): blocks up to 32 MiB
    come from the heap, whose top is never given back. By default glibc
    moves its mmap threshold as blocks are freed and trims the heap's top,
    so whether a frame's fresh host image (7.7 MB at 800 x 800) lands on
    pages already mapped or on new ones depends on the heap's history: a
    run then spends ~1 ms of kernel time a frame, or none, for the whole
    window. True where both thresholds were set."""
    import ctypes
    import ctypes.util
    try:
        mallopt = ctypes.CDLL(ctypes.util.find_library("c")).mallopt
    except (OSError, AttributeError, TypeError):
        return False
    m_trim_threshold, m_mmap_threshold = -1, -3
    return bool(mallopt(m_trim_threshold, 1 << 30)
                and mallopt(m_mmap_threshold, 32 << 20))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


@contextlib.contextmanager
def precision(control: bool):
    """The control's precision: TF32 matrix products and convolutions (the
    step below the configuration's float32 with TF32 off); otherwise off."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = control
    torch.backends.cudnn.allow_tf32 = control
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


VIS_CHECK_RAYS = 4096   # traced rays the visibility check samples


def vis_rays(st) -> tuple[torch.Tensor, torch.Tensor]:
    """(points, sample indices) of the rays the visibility check reads,
    drawn from the seed."""
    c, dev = st.ctx.config, st.ctx.device
    gen = torch.Generator(device="cpu").manual_seed(st.ctx.seed + 3)
    n = min(VIS_CHECK_RAYS, c["points"] * c["sample_num"])
    flat = torch.randperm(c["points"] * c["sample_num"], generator=gen)[:n]
    return ((flat // c["sample_num"]).to(dev), (flat % c["sample_num"]).to(dev))


def program_vis(st) -> torch.Tensor:
    """The program's traced visibility at the checked rays."""
    rows, cols = vis_rays(st)
    return st.extra["vis_values"][rows, cols, 0]


def reference_vis(st, params: dict, control: bool = False) -> torch.Tensor:
    """The reference's trace of the checked rays from `params`; the
    control's in bfloat16: the tracer's float32 arithmetic has no matrix
    product for TF32 to round, so its step below is bfloat16."""
    from ..reference import neilf
    rows, cols = vis_rays(st)
    dirs, _ = neilf.samples(params, st.ctx.config["sample_num"])
    if control:
        params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    return neilf.visibility_sample(params, dirs.to(params["xyz"].dtype),
                                   rows, cols)


def vis_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Mean |program − reference| visibility over the checked rays."""
    return float((prog.double() - ref.double()).abs().mean())


def stage2_reference(st, params: dict, dtype) -> dict:
    """The reference's readings over stage 2's check steps (`params` holds
    every leaf, the env map as "env"), on the program's traced visibility,
    and its own trace of the checked rays."""
    import dataclasses
    from ..reference import neilf
    from ..reference import train as R
    c, s, dev = st.ctx.config, st.inputs, st.ctx.device
    adam = R.Adam(params, step=c["first_iter"])
    adam.t["env"] = 0                       # the env map's own Adam
    stats = R.zero_stats(params["xyz"].shape[0], params["xyz"])
    cams = reference_cameras(st.ctx, s.cams, dtype)
    dirs, areas = neilf.samples(params, c["sample_num"])
    vis = st.extra["vis_values"].to(dtype)
    bg = torch.zeros(3, dtype=dtype, device=dev)
    opt = dataclasses.asdict(st.opt)
    out = {"losses": [], "vis": reference_vis(st, params,
                                              control=dtype != torch.float64)}
    for j, (v, it) in enumerate(zip(st.check_views, st.iterations)):
        img, mask = s.images[v]
        loss, grads = neilf.stage2_step(
            params, adam, stats, RefView(cams[v], img.to(dtype), mask.to(dtype)),
            it, vis, dirs, areas, cfg=raster_config(c), opt=opt,
            spatial_lr_scale=s.extent, bg=bg)
        out["losses"].append(float(loss))
        if j == 0:
            out["grads"] = {k: g.detach().clone() for k, g in grads.items()}
    out["params"] = {k: v.detach() for k, v in params.items()}
    out["stats"] = stats
    return out

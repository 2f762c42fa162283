"""Relighting-evaluation traffic: the Synthetic4Relight benchmark's loop
(`cli.eval_relighting_syn4`) on a finished stage-2 model, each unit one
test view rendered under a fixed HDR map and scored against its ground
truth through the program's `relight_view`, the CLI's own per-view body:
the render (`render_neilf(is_training=False)`, K6 at the configuration's
S, K1 at the eval width) with the scene's albedo scale, the images over
the mask, and PSNR, SSIM and LPIPS of the PBR render and of the albedo
and the roughness MSE, on the host. The CLI's PNGs are its own I/O and
are not written.

Set-up makes the points and their PBR fields from the seed (as `frames`
does), two seeded HDR skies for the benchmark's two maps, the ground
truth of every test view (`ground_truth`: the spheres of `scene.py`
ray-cast, their Lambert image, albedo and roughness, and the mask), kept
in pinned host memory as the CLI keeps its images on disk (a unit copies
its view's to the card, as the CLI loads one view's at a time), selects LPIPS's seeded backbone (LPIPS_WEIGHTS=random) and traces the
visibility once (K3 over P x S rays). The window runs the CLI's order,
every test view of the orbit under the first map, then every view under
the second, cycling, from a unit drawn from the seed. A unit's time is
CUDA events from the call until its seven scores are on the host; the
rate is units over the window's host-clock length.

The check compares a sample of the window's units, drawn from the seed
among its first `sample_range` (the window runs at least those), with
the reference's evaluation of the same view and map
(`reference/relight_eval.py`, float64, on the program's traced
visibility, LPIPS with the program's seeded weights): the masked PBR,
albedo and roughness images, the render's own `pbr_env`, the seven
scores, and the visibility of a seeded sample of rays traced by the
reference itself.

Traffic keys: orbit_views, elevation_deg, env_height, warm_frames,
sample_frames, sample_range, trace_frames.
"""
from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from .. import scene, work, work_eval
from ..harness import Window, phase
from ..reference.relight_eval import SCORES
from ..trace import TraceData, from_profiler
from . import common

# Each sphere's roughness in the ground truth (scene.SPHERES' order).
ROUGHNESS = (0.35, 0.5, 0.25, 0.65, 0.3, 0.8, 0.45, 0.15)
IMAGES = ("pbr", "base_color", "roughness")
A_EVAL = 32        # K1's attributes at the eval render: rgb, 27, depth, 1


@torch.no_grad()
def ground_truth(cam: tuple, c: dict, device) -> tuple:
    """(image [3, H, W], mask [1, H, W], albedo [3, H, W], roughness
    [3, H, W]) of the spheres from `cam`: scene.ground_truth's Lambert
    image and mask, and the albedo and roughness of each pixel's nearest
    sphere (0 where none is hit)."""
    H, W = c["height"], c["width"]
    image, mask = scene.ground_truth(cam, W, H, c["camera_angle_x"], device)
    R, T = cam
    f = W / (2 * math.tan(c["camera_angle_x"] / 2))
    u = torch.arange(W, device=device, dtype=torch.float32)
    v = torch.arange(H, device=device, dtype=torch.float32)
    d = torch.stack([((u[None, :] - W / 2) / f).expand(H, W),
                     ((v[:, None] - H / 2) / f).expand(H, W),
                     torch.ones((H, W), device=device)], -1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    d = d @ torch.tensor(R, dtype=torch.float32, device=device).T
    o = torch.tensor(-R @ T, dtype=torch.float32, device=device)
    best = torch.full((H, W), float("inf"), device=device)
    albedo = torch.zeros((H, W, 3), device=device)
    rough = torch.zeros((H, W, 1), device=device)
    for (centre, r, rgb), g in zip(scene.SPHERES, ROUGHNESS):
        oc = o - torch.tensor(centre, device=device)
        b = (d * oc).sum(-1)
        disc = b * b - (oc * oc).sum() + r * r
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        hit = (disc > 0) & (t > 0) & (t < best)
        albedo = torch.where(hit[..., None], torch.tensor(rgb, device=device),
                             albedo)
        rough = torch.where(hit[..., None], torch.full((1,), g, device=device),
                            rough)
        best = torch.where(hit, t, best)
    return (image, mask, albedo.permute(2, 0, 1).contiguous(),
            rough.permute(2, 0, 1).expand(3, H, W).contiguous())


def setup(ctx):
    from relightable3dgaussian_tpu_torch.cli.eval_relighting_syn4 import (
        GroundTruth, relight_view)
    from relightable3dgaussian_tpu_torch.losses import lpips
    from relightable3dgaussian_tpu_torch.models import gaussians as G
    from relightable3dgaussian_tpu_torch.models.lights import EnvLight
    from relightable3dgaussian_tpu_torch.models.render_neilf import (
        update_visibility)
    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    st = common.State(ctx=ctx, inputs=None)
    st.extra["lpips_env"] = os.environ.get("LPIPS_WEIGHTS")
    os.environ["LPIPS_WEIGHTS"] = "random"
    lpips.reset()
    if not lpips.is_random_backbone():
        raise RuntimeError("relight_eval: LPIPS did not take its seeded "
                           "backbone")
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    fields = scene.make_points(c["points"], gen, dev)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 2)
    fields.update(scene.make_pbr(c["points"], fields, gen, dev))
    st.extra["maps"] = [scene.env_map(tr["env_height"], gen, dev)
                        for _ in range(2)]
    st.extra["fields"] = fields
    st.model = G.GaussianModel(**{k: v.clone() for k, v in fields.items()})
    common.sync(dev)
    phase("points, PBR fields, maps")
    st.vis = update_visibility(st.model, c["sample_num"])
    st.extra["vis_values"] = st.vis.visibility
    common.sync(dev)
    phase(f"visibility ({c['points']} x {c['sample_num']} rays)")
    orbit = scene.orbit_cameras(tr["orbit_views"], c["camera_radius"],
                                tr["elevation_deg"])
    st.extra["orbit"] = orbit
    truth = torch.empty((len(orbit), 10, c["height"], c["width"]),
                        pin_memory=dev.type == "cuda")
    for k, cam in enumerate(orbit):
        truth[k].copy_(torch.cat(ground_truth(cam, c, dev)))
    st.extra["truth"] = truth
    common.sync(dev)
    phase(f"{len(orbit)} ground truths")
    st.extra.update(
        envs=[EnvLight(envmap=m) for m in st.extra["maps"]],
        ground_truth=GroundTruth,
        scale=torch.tensor(c["base_color_scale"], device=dev),
        first=ctx.seed % (2 * tr["orbit_views"]),
        cfg=common.program_raster_config(c), relight_view=relight_view)
    for i in range(tr["warm_frames"]):
        _unit(st, i)
    common.sync(dev)
    phase(f"first {tr['warm_frames']} views")
    return st


def _pose(st, i: int) -> tuple[int, int]:
    """Unit i's (orbit view, map): the views under map 0, then map 1."""
    n = len(st.extra["orbit"])
    return (st.extra["first"] + i) % n, \
        ((st.extra["first"] + i) // n) % 2


def _unit(st, i: int):
    """Unit i: its view's camera, built as the CLI builds it from the
    pose, and `relight_view`. Returns (view, map, its RelitView)."""
    from relightable3dgaussian_tpu_torch.models.render import ViewInputs
    from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
    c = st.ctx.config
    k, m = _pose(st, i)
    R, T = st.extra["orbit"][k]
    fovx, fovy = common.fovs(c)
    cam = make_camera_params(R, T, c["width"], c["height"], fovx=fovx,
                             fovy=fovy, device=st.ctx.device)
    view = ViewInputs(cam=cam, image=None, image_mask=None, depth=None,
                      normal=None)
    gt = st.extra["ground_truth"](*_truth(st, k))
    rv = st.extra["relight_view"](
        view, st.model, st.extra["cfg"], st.extra["envs"][m], st.vis, gt,
        base_color_scale=st.extra["scale"], background=c["background"])
    return k, m, rv


def _truth(st, k: int, dtype=torch.float32) -> tuple:
    """View k's ground truth on the device: (image [3, H, W], mask [1, H,
    W], albedo [3, H, W], roughness [3, H, W])."""
    t = st.extra["truth"][k].to(st.ctx.device, dtype, non_blocking=True)
    return t[:3], t[3:4], t[4:7], t[7:]


def window(st, seconds: float, trace: bool) -> Window:
    tr, dev = st.ctx.traffic, st.ctx.device
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(st.ctx.seed)
    limit = tr["trace_frames"] if trace else None
    span = min(tr["sample_range"], limit or tr["sample_range"])
    sample = set(rng.choice(span, tr["sample_frames"], replace=False).tolist())
    need = max(sample) + 1      # the window runs at least the checked units
    kept, poses, times, events = {}, [], [], []
    prof = None
    if trace:
        prof = common.profiler()
        prof.start()
    common.sync(dev)
    t0 = time.perf_counter()
    t_end = t0 + seconds
    i = 0
    while (i < limit) if trace else (time.perf_counter() < t_end
                                     or i < need):
        if on_card:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        else:
            t_unit = time.perf_counter()
        k, m, rv = _unit(st, i)
        if on_card:
            ev[1].record()
            events.append(ev)
        else:
            times.append(1e3 * (time.perf_counter() - t_unit))
        poses.append(k)
        if i in sample:    # device copies; to the host after the window
            maps = {n: rv.images[n] for n in IMAGES}
            maps["pbr_env"] = rv.results["pbr_env"]
            kept[i] = (k, m, maps, rv.scores)
        i += 1
    common.sync(dev)
    window_s = time.perf_counter() - t0
    if on_card:
        times = [a.elapsed_time(b) for a, b in events]
    st.extra["kept"] = {i: (k, m, {n: x.cpu() for n, x in maps.items()}, sc)
                        for i, (k, m, maps, sc) in kept.items()}
    win = Window(units=i, window_s=window_s, end_to_end={
        "frames_per_s": i / window_s,
        "frame_ms.p95": float(np.percentile(times, 95))})
    if trace:
        prof.stop()
        device, host = from_profiler(prof)
        win.trace = TraceData(kind="frame", units=i, window_s=window_s,
                              device=device, host=host,
                              work=[_unit_work(st, k) for k in poses])
    return win


def _unit_work(st, k: int) -> dict:
    """The counted work of one unit at orbit view k: K1's on the reference
    walk's pairs from that camera, K6's, and the whole view's."""
    c = st.ctx.config
    cache = st.extra.setdefault("unit_work", {})
    if k not in cache:
        g = {n: st.extra["fields"][n] for n in ("xyz", "scaling", "rotation",
                                               "opacity")}
        cam = common.reference_cameras(st.ctx, [st.extra["orbit"][k]],
                                       torch.float32)[0]
        pairs, walked, blended = common.walk_counts_at(st, g, cam)
        P, S = g["xyz"].shape[0], c["sample_num"]
        env_h = st.ctx.traffic["env_height"]
        cache[k] = {
            "k1": work.k1_work(P, pairs, common.raster_config(c).num_tiles,
                               A_EVAL, walked, blended),
            "k6": work_eval.k6_work(P, S, env_h, 2 * env_h),
            "frame": (0, work_eval.view_ops(P, S, walked, blended, A_EVAL,
                                            c["height"], c["width"]))}
    return cache[k]


def release(st) -> None:
    from relightable3dgaussian_tpu_torch.losses import lpips
    st.model = st.vis = None
    st.extra.pop("envs", None)
    saved = st.extra.pop("lpips_env", None)
    if saved is None:
        os.environ.pop("LPIPS_WEIGHTS", None)
    else:
        os.environ["LPIPS_WEIGHTS"] = saved
    lpips.reset()
    common.free(st.ctx.device)


def lpips_weights(device, dtype) -> dict:
    """The program's seeded LPIPS weights (LPIPS_WEIGHTS=random), handed
    to the reference as tensors."""
    from relightable3dgaussian_tpu_torch.losses import lpips
    saved = os.environ.get("LPIPS_WEIGHTS")
    os.environ["LPIPS_WEIGHTS"] = "random"
    lpips.reset()
    try:
        w = lpips.weights()
    finally:
        if saved is None:
            os.environ.pop("LPIPS_WEIGHTS", None)
        else:
            os.environ["LPIPS_WEIGHTS"] = saved
        lpips.reset()
    return {k: torch.as_tensor(v, device=device).to(dtype)
            for k, v in w.items()}


@torch.no_grad()
def readings(st, control=False) -> dict:
    """The reference's evaluation of each kept unit ({"units": {i:
    (images, scores)}}) and its trace of the checked rays ("vis"): in
    float64; with `control` True in float32 with TF32 convolutions and
    products (and the tracer in bfloat16); with "bfloat16" in float64 but
    LPIPS in bfloat16."""
    from ..reference import neilf
    from ..reference import relight_eval as RE
    c, dev = st.ctx.config, st.ctx.device
    dtype = torch.float32 if control is True else torch.float64
    with common.precision(control is True):
        params = {n: v.to(dtype) for n, v in st.extra["fields"].items()}
        dirs, areas = neilf.samples(params, c["sample_num"])
        vis = st.extra["vis_values"].to(dtype)
        cfg = common.raster_config(c)
        scale = torch.tensor(c["base_color_scale"], dtype=dtype, device=dev)
        weights = lpips_weights(dev, torch.bfloat16 if control == "bfloat16"
                                else dtype)
        units = {}
        for i, (k, m, _, _) in st.extra["kept"].items():
            cam = common.reference_cameras(st.ctx, [st.extra["orbit"][k]],
                                           dtype)[0]
            res = RE.render(params, cam, cfg, c["background"],
                            st.extra["maps"][m].to(dtype), vis, dirs, areas,
                            scale)
            image, mask, albedo, rough = _truth(st, k, dtype)
            img = RE.images(res, {"image": image, "mask": mask,
                                  "albedo": albedo, "roughness": rough},
                            c["background"])
            scores = RE.scores(img, weights)
            maps = {n: img[n].cpu() for n in IMAGES}
            maps["pbr_env"] = res["pbr_env"].cpu()
            units[i] = (maps, scores)
        del dirs, areas, vis
        out = {"units": units,
               "vis": common.reference_vis(st, params, control is True)}
    return out


def compare(st, ref: dict, side: dict) -> dict:
    """The worst unit's mean |program - reference| of each image, |Δ| of
    each score, and the visibility's mean |Δ| over the checked rays."""
    numbers = {n: (0.0 if ref["units"] else math.inf) for n in
               [f"{m}_mae" for m in IMAGES + ("pbr_env",)] + list(SCORES)}
    for i, (maps, scores) in ref["units"].items():
        p_maps, p_scores = side["units"][i]
        got = {f"{n}_mae": float((p_maps[n].double() - maps[n].double())
                                 .abs().mean()) for n in maps}
        got.update({n: abs(p_scores[n] - v) for n, v in scores.items()})
        for n, v in got.items():
            numbers[n] = max(numbers[n], v if v == v else math.inf)
    numbers["vis"] = common.vis_gap(side["vis"], ref["vis"])
    return numbers


def program_side(st) -> dict:
    return {"units": {i: (maps, sc) for i, (_, _, maps, sc)
                      in st.extra["kept"].items()},
            "vis": common.program_vis(st)}


def check(st) -> dict:
    return compare(st, readings(st), program_side(st))

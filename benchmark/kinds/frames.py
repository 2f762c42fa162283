"""Frame traffic: the viewer's closed loop of full frames along an orbit,
each frame from the call until its image is in host memory.

`render` "render": `models.render.render` (as `cli/gui.py` and
`cli.eval_nvs` call it), the RGB to the host. `render` "relight":
`cli.relighting`'s frame loop, `render_neilf(is_training=False)` under an
HDR env map rotated each frame (`light_transform`), the `pbr_env` image
to the host, with visibility traced once at set-up. The orbit starts at a
view drawn from the seed. A frame's time is CUDA events around it (the
stream is idle between frames, so the start event marks the call); the
rate is frames over the window's host-clock length. The process's heap
is fixed first (`common.fixed_heap`), so that every frame's host image
costs the same whatever the heap's history.

The check compares a sample of the window's frames, drawn from the seed
among its first `sample_range`, with the reference's render of the same
view: the image, the depth and the normal map.

Traffic keys: render, orbit_views, elevation_deg, warm_frames,
sample_frames, sample_range, trace_frames; relight: env_height.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import scene, work
from ..harness import Window, phase
from ..trace import TraceData, from_profiler
from . import common


def setup(ctx):
    from relightable3dgaussian_tpu_torch.models import gaussians as G
    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    phase("heap fixed" if common.fixed_heap() else "heap left as it is")
    s = common.inputs(ctx, with_images=False)
    st = common.State(ctx=ctx, inputs=s)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 2)
    fields = dict(s.fields)
    if tr["render"] == "relight":
        fields.update(scene.make_pbr(c["points"], s.fields, gen, dev))
        st.extra["envmap"] = scene.env_map(tr["env_height"], gen, dev)
    st.extra["fields"] = fields
    st.model = G.GaussianModel(**{k: v.clone() for k, v in fields.items()})
    st.extra["orbit"] = scene.orbit_cameras(tr["orbit_views"],
                                            c["camera_radius"],
                                            tr["elevation_deg"])
    st.extra["first"] = ctx.seed % tr["orbit_views"]
    if tr["render"] == "relight":
        from relightable3dgaussian_tpu_torch.models.render_neilf import (
            update_visibility)
        st.vis = update_visibility(st.model, c["sample_num"])
        st.extra["vis_values"] = st.vis.visibility
    common.sync(dev)
    phase("model" + (", env map, visibility" if st.vis else ""))
    for i in range(tr["warm_frames"]):
        _frame(st, i)
    common.sync(dev)
    phase(f"first {tr['warm_frames']} frames")
    return st


def _view(st, i: int):
    """Frame i's pose (its index in the orbit) and the program's view of it,
    built per frame as the viewer builds it from its pose."""
    from relightable3dgaussian_tpu_torch.models.render import ViewInputs
    from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
    c, orbit = st.ctx.config, st.extra["orbit"]
    k = (st.extra["first"] + i) % len(orbit)
    R, T = orbit[k]
    fovx, fovy = common.fovs(c)
    cam = make_camera_params(R, T, c["width"], c["height"], fovx=fovx,
                             fovy=fovy, device=st.ctx.device)
    return k, ViewInputs(cam=cam, image=None, image_mask=None, depth=None,
                         normal=None)


def light_transform(k: int, n: int) -> np.ndarray:
    """The env map's rotation at orbit frame k of n: about +z by 2πk/n."""
    a = 2 * math.pi * k / n
    return np.array([[math.cos(a), -math.sin(a), 0.0],
                     [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]],
                    np.float32)


@torch.no_grad()
def _frame(st, i: int) -> tuple[int, dict, torch.Tensor]:
    """Render frame i and bring its image to the host: (orbit index, the
    results, the host image)."""
    c, tr, dev = st.ctx.config, st.ctx.traffic, st.ctx.device
    k, view = _view(st, i)
    cfg = common.program_raster_config(c)
    bg = torch.zeros(3, device=dev)
    if tr["render"] == "relight":
        from relightable3dgaussian_tpu_torch.models.lights import EnvLight
        from relightable3dgaussian_tpu_torch.models.render_neilf import (
            render_neilf)
        env = EnvLight(envmap=st.extra["envmap"], transform=torch.tensor(
            light_transform(k, tr["orbit_views"]), device=dev))
        res = render_neilf(view, st.model, cfg, bg, env, st.vis,
                           is_training=False)
        image = res["pbr_env"].cpu()
    else:
        from relightable3dgaussian_tpu_torch.models.render import render
        res = render(view, st.model, cfg, bg)
        image = res["render"].cpu()
    return k, res, image


def window(st, seconds: float, trace: bool) -> Window:
    tr, dev = st.ctx.traffic, st.ctx.device
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(st.ctx.seed)
    limit = tr["trace_frames"] if trace else None
    span = min(tr["sample_range"], limit or tr["sample_range"])
    sample = set(rng.choice(span, tr["sample_frames"], replace=False).tolist())
    kept, frames, times, events = {}, [], [], []
    prof = None
    if trace:
        prof = common.profiler()
        prof.start()
    common.sync(dev)
    t0 = time.perf_counter()
    t_end = t0 + seconds
    i = 0
    while (i < limit) if trace else (time.perf_counter() < t_end):
        if on_card:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        else:
            t_frame = time.perf_counter()
        k, res, image = _frame(st, i)
        if on_card:
            ev[1].record()
            events.append(ev)
        else:
            times.append(1e3 * (time.perf_counter() - t_frame))
        frames.append(k)
        if i in sample:    # device copies; to the host after the window
            kept[i] = (k, {"image": image, "depth": res["depth"].clone(),
                           "normal": res["normal"].clone()})
        i += 1
    common.sync(dev)
    window_s = time.perf_counter() - t0
    if on_card:
        times = [a.elapsed_time(b) for a, b in events]
    st.extra["kept"] = {i: (k, {n: x.cpu() for n, x in maps.items()})
                        for i, (k, maps) in kept.items()}
    win = Window(units=i, window_s=window_s, end_to_end={
        "frames_per_s": i / window_s,
        "frame_ms.p95": float(np.percentile(times, 95))})
    if trace:
        prof.stop()
        device, host = from_profiler(prof)
        win.trace = TraceData(kind="frame", units=i, window_s=window_s,
                              device=device, host=host,
                              work=[_frame_work(st, k) for k in frames])
    return win


def _frame_work(st, k: int) -> dict:
    """The counted work of one frame at orbit view k: the reference walk's
    pairs on the model's geometry from that camera."""
    c, tr = st.ctx.config, st.ctx.traffic
    cache = st.extra.setdefault("frame_work", {})
    if k not in cache:
        g = {n: st.extra["fields"][n] for n in ("xyz", "scaling", "rotation",
                                               "opacity")}
        cam = common.reference_cameras(st.ctx, [st.extra["orbit"][k]],
                                       torch.float32)[0]
        pairs, walked, blended = common.walk_counts_at(st, g, cam)
        P = g["xyz"].shape[0]
        relight = tr["render"] == "relight"
        A = 32 if relight else 9
        S = c["sample_num"] if relight else 0
        tiles = common.raster_config(c).num_tiles
        cache[k] = {"k1": work.k1_work(P, pairs, tiles, A, walked, blended),
                    "frame": (0, work.frame_ops(P, walked, blended, A, S))}
    return cache[k]


def release(st) -> None:
    st.model = st.vis = None
    common.free(st.ctx.device)


@torch.no_grad()
def reference_frame(st, k: int, dtype) -> dict:
    """The reference's render of orbit frame k from the benchmark's own
    inputs (relighting: on the program's traced visibility), in `dtype`:
    the captured image, the depth and the normal map, on the host."""
    from ..reference import render as RR
    c, tr, dev = st.ctx.config, st.ctx.traffic, st.ctx.device
    params = {n: v.to(dtype) for n, v in st.extra["fields"].items()}
    cam = common.reference_cameras(st.ctx, [st.extra["orbit"][k]], dtype)[0]
    cfg = common.raster_config(c)
    bg = torch.zeros(3, dtype=dtype, device=dev)
    if tr["render"] == "relight":
        from ..reference import neilf
        dirs, areas = neilf.samples(params, c["sample_num"])
        transform = torch.tensor(light_transform(k, tr["orbit_views"]),
                                 device=dev).to(dtype)
        res = neilf.render_eval(params, cam, cfg, bg,
                                st.extra["envmap"].to(dtype), transform,
                                st.extra["vis_values"].to(dtype), dirs, areas)
        image = res["pbr_env"]
    else:
        res = RR.render_view(params, cam, cfg, bg)
        image = res["render"]
    return {"image": image.cpu(), "depth": res["depth"].cpu(),
            "normal": res["normal"].cpu()}


def readings(st, control: bool = False) -> dict:
    """The reference's render of each kept frame ({"frames": {i: maps}}),
    and for relighting its trace of the checked rays ("vis")."""
    dtype = torch.float32 if control else torch.float64
    with common.precision(control):
        out = {"frames": {i: reference_frame(st, k, dtype)
                          for i, (k, _) in st.extra["kept"].items()}}
        if st.ctx.traffic["render"] == "relight":
            out["vis"] = common.reference_vis(
                st, {n: v.to(dtype) for n, v in st.extra["fields"].items()},
                control)
    return out


def compare(st, ref: dict, side: dict) -> dict:
    from .. import checks
    numbers = checks.worst([checks.frame_numbers(side["frames"][i], m)
                            for i, m in ref["frames"].items()])
    if "vis" in ref:
        numbers["vis"] = common.vis_gap(side["vis"], ref["vis"])
    return numbers


def program_side(st) -> dict:
    out = {"frames": {i: maps for i, (_, maps) in st.extra["kept"].items()}}
    if st.ctx.traffic["render"] == "relight":
        out["vis"] = common.program_vis(st)
    return out


def check(st) -> dict:
    return compare(st, readings(st), program_side(st))

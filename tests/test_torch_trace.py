"""The port's tracer (utils/trace.py) on the CPU: spans off and on, their
records against torch.profiler's own events, self time, threads, sessions,
counters, and the span tree of a stage-1 and a stage-2 train step and of a
stage-1 and a stage-2 eval render."""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from relightable3dgaussian_tpu_torch.models import gaussians as G
from relightable3dgaussian_tpu_torch.models import render_neilf
from relightable3dgaussian_tpu_torch.models.lights import DirectLightMap
from relightable3dgaussian_tpu_torch.models.render import ViewInputs, render
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.train import optim, stage1, stage2
from relightable3dgaussian_tpu_torch.train.config import (
    STAGE1_NERF_SYNTHETIC, STAGE2_NERF_SYNTHETIC, OptimizationConfig)
from relightable3dgaussian_tpu_torch.utils import trace
from test_torch_ops import SIZE, cameras, random_scene, t

S = 8          # stage-2 incident samples a point


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


def tree(records) -> set:
    """(name, parent's name) of every record."""
    return {(r.name, None if r.parent is None else records[r.parent].name)
            for r in records}


def test_span_off_is_the_shared_null_context_and_records_nothing(
        monkeypatch):
    with profiled():
        with trace.span("before"):
            pass
    assert [r.name for r in trace.collect()] == ["before"]

    def refuse(*a, **k):
        raise AssertionError("a span took a timestamp or made an event")

    monkeypatch.setattr(trace.time, "time_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd._profiler_enabled()
    for _ in range(3):
        sp = trace.span("off", unit=True, device=torch.device("cuda"))
        assert sp is trace.NULL
        with sp as inner:
            inner.events(None, None)
    monkeypatch.undo()
    assert [r.name for r in trace.collect()] == ["before"]


def test_records_carry_name_parent_unit_and_lie_in_their_ranges():
    with profiled() as prof:
        for _ in range(3):
            with trace.span("u", unit=True):
                with trace.span("a"):
                    with trace.span("b"):
                        torch.ones(100).sum()
                    with trace.span("u", unit=True):     # inside a unit
                        pass
                with trace.span("c"):
                    time.sleep(1e-3)
        with trace.span("loose"):
            pass
    records = trace.collect()
    assert [r.name for r in records] == ["u", "a", "b", "u", "c"] * 3 + [
        "loose"]
    for k in range(3):
        u, a, b, inner, c = records[5 * k:5 * k + 5]
        assert (u.parent, u.unit) == (None, k + 1)
        assert (a.parent, b.parent, inner.parent, c.parent) == (
            u.index, a.index, a.index, u.index)
        assert {a.unit, b.unit, inner.unit, c.unit} == {k + 1}
        assert u.counts == {} and inner.counts is None
    assert (records[-1].parent, records[-1].unit) == (None, None)
    assert [r.unit for r in trace.units(records, "u")] == [1, 2, 3]

    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((e for e in prof.events()
                     if e.name in {"u", "a", "b", "c", "loose"}),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in events] == [r.name for r in records]
    for k, (r, e) in enumerate(zip(records, events)):
        lo = t0 + round(e.time_range.start * 1e3)
        hi = t0 + round(e.time_range.end * 1e3)
        assert lo <= r.start_ns <= r.end_ns <= hi, (r.name, k)
        if k:
            assert r.start_ns - lo <= 1_000_000 and hi - r.end_ns <= 1_000_000


def _rec(name, index, parent, start, end):
    r = trace.Record(name, index, parent)
    r.start_ns, r.end_ns = start, end
    return r


def test_self_time_is_the_duration_minus_what_children_cover():
    top = _rec("top", 0, None, 0, 100)
    kids = [_rec("a", 1, top, 10, 30), _rec("b", 2, top, 20, 50),
            _rec("c", 3, top, 90, 120)]
    grandchild = _rec("g", 4, kids[0], 12, 28)
    records = [top, *kids, grandchild]
    assert trace.self_ns(records, top) == 100 - 40 - 10
    assert trace.self_ns(records, kids[0]) == 20 - 16
    assert trace.self_ns(records, grandchild) == 16

    with profiled():
        with trace.span("top", unit=True):
            for _ in range(3):
                with trace.span("child"):
                    with trace.span("leaf"):
                        time.sleep(2e-4)
                time.sleep(1e-4)
    records = trace.collect()
    top = records[0]
    assert sum(trace.self_ns(records, r) for r in records) == top.duration_ns
    assert trace.unit_mean_ms("top", "top", own=False) == pytest.approx(
        top.duration_ns * 1e-6)
    assert trace.unit_mean_ms("top", "absent") is None


def test_a_span_on_another_thread_takes_the_open_unit_and_parent(
        monkeypatch):
    """As the autograd engine's worker on the card, which runs a backward
    with the calling thread's profiler state (a plain thread here is given
    it by hand)."""
    seen = {}

    def worker():
        with trace.span("worker.op"):
            with trace.span("worker.inner"):
                seen["thread"] = threading.get_ident()

    with profiled():
        with trace.span("train.step", unit=True):
            with trace.span("train.backward"):
                monkeypatch.setattr(torch.autograd, "_profiler_enabled",
                                    lambda: True)
                th = threading.Thread(target=worker)
                th.start()
                th.join(timeout=30)
                monkeypatch.undo()
            with trace.span("train.optimizer"):
                pass
    assert not th.is_alive() and seen["thread"] != threading.get_ident()
    records = trace.collect()
    by = {r.name: r for r in records}
    assert by["worker.op"].parent == by["train.backward"].index
    assert by["worker.inner"].parent == by["worker.op"].index
    assert by["train.optimizer"].parent == by["train.step"].index
    assert {r.unit for r in records} == {1}


def test_two_profiling_sessions_keep_their_records_apart():
    with profiled():
        with trace.span("first", unit=True):
            pass
    with trace.span("between"):          # the profiler is off
        pass
    with profiled():
        with trace.span("second", unit=True):
            pass
    assert [(r.name, r.unit) for r in trace.collect()] == [("second", 1)]
    with profiled():                     # collect() ended the last one
        with trace.span("third", unit=True):
            pass
    assert [(r.name, r.unit) for r in trace.collect()] == [("third", 1)]
    assert trace.unit_mean_count("second", "host.syncs") is None


def test_counters_count_with_tracing_on_or_off():
    trace.set_counter("test.things", 0)
    trace.count("test.things")
    with profiled():
        with trace.span("unit", unit=True):
            trace.count("test.things", 2)
            with trace.span("child"):
                trace.count("test.things")
    assert trace.counter("test.things") == 4
    assert trace.collect()[0].counts == {"test.things": 3}
    assert trace.unit_mean_count("unit", "test.things") == 3
    trace.set_counter("test.things", 7)
    assert trace.counter("test.things") == 7
    assert trace.counter("test.never") == 0


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------

def small_model(pbr: bool) -> G.GaussianModel:
    means, scales, rots, opacity, shs, _ = random_scene(3, deg=3)
    rng = np.random.default_rng(4)
    fields = dict(xyz=t(means), normal=t(rng.normal(size=means.shape)
                                         .astype(np.float32)),
                  shs_dc=t(shs[:, :1]), shs_rest=t(shs[:, 1:]),
                  scaling=torch.log(t(scales)), rotation=t(rots),
                  opacity=torch.logit(t(opacity)))
    model = G.GaussianModel(**fields)
    if pbr:
        G.add_pbr_params(model)
    return model


def view() -> ViewInputs:
    _, cam = cameras()
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32) / SIZE
    gt = np.stack([0.2 + 0.5 * xx, 0.3 + 0.4 * yy, 0.6 - 0.3 * xx * yy])
    return ViewInputs(cam, t(gt), torch.ones((1, SIZE, SIZE)),
                      torch.zeros((1, SIZE, SIZE)),
                      torch.zeros((3, SIZE, SIZE)))


RENDER = {("render.view", "train.forward"),
          ("render.projection", "render.view"),
          ("render.binning", "render.view"), ("train.loss", "render.view")}
STEP = {("train.step", None), ("train.forward", "train.step"),
        ("train.backward", "train.step"), ("train.optimizer", "train.step")}


def _one_unit(records, top: str) -> None:
    assert [r.name for r in records if r.parent is None] == [top]
    assert {r.unit for r in records} == {1}
    assert len(trace.units(records, top)) == 1


def test_a_stage1_train_step_gives_the_span_tree():
    model = small_model(pbr=False)
    opt = OptimizationConfig(**STAGE1_NERF_SYNTHETIC)
    optimizer = optim.make_optimizer(model, opt, 1.0)
    with profiled():
        stage1.train_step(model, optimizer, view(), 1,
                          cfg=RasterConfig(SIZE, SIZE), opt=opt,
                          spatial_lr_scale=1.0)
    records = trace.collect()
    assert tree(records) == STEP | RENDER
    _one_unit(records, "train.step")
    for name in ("render.projection", "render.binning", "render.view",
                 "train.loss"):
        assert trace.unit_mean_ms("train.step", name) > 0, name
    assert trace.unit_mean_count("train.step", "host.syncs") >= 1


def test_a_stage2_train_step_gives_the_span_tree():
    model = small_model(pbr=True)
    opt = OptimizationConfig(**STAGE2_NERF_SYNTHETIC)
    vis = render_neilf.update_visibility(model, S)
    env = DirectLightMap(8, generator=torch.Generator().manual_seed(5),
                         device="cpu")
    optimizer = optim.make_optimizer(model, opt, 1.0)
    optim.start_state(optimizer, 30_000)
    env_optimizer = optim.make_env_optimizer(env, opt)
    with profiled():
        stage2.train_step(model, optimizer, env, env_optimizer, vis, view(),
                          30_001, cfg=RasterConfig(SIZE, SIZE), opt=opt,
                          spatial_lr_scale=1.0)
    records = trace.collect()
    assert tree(records) == STEP | RENDER | {("render.shading",
                                              "render.view")}
    _one_unit(records, "train.step")
    assert trace.unit_mean_ms("train.step", "render.shading") > 0
    # device events only on the card
    assert trace.unit_mean_device_ms("train.step", "render.shading") is None


def test_eval_renders_give_one_view_unit_each():
    bg = torch.zeros(3)
    cfg = RasterConfig(SIZE, SIZE)
    with torch.no_grad(), profiled():
        render(view(), small_model(pbr=False), cfg, bg)
    records = trace.collect()
    assert tree(records) == {("render.view", None),
                             ("render.projection", "render.view"),
                             ("render.binning", "render.view")}
    _one_unit(records, "render.view")
    assert trace.unit_mean_ms("train.step", "render.view") is None

    model = small_model(pbr=True)
    vis = render_neilf.update_visibility(model, S)
    env = DirectLightMap(8, generator=torch.Generator().manual_seed(6),
                         device="cpu")
    with torch.no_grad(), profiled():
        render_neilf.render_neilf(view(), model, cfg, bg, env, vis,
                                  is_training=False)
    records = trace.collect()
    assert tree(records) == {("render.view", None),
                             ("render.shading", "render.view"),
                             ("render.projection", "render.view"),
                             ("render.binning", "render.view")}
    _one_unit(records, "render.view")
    assert trace.unit_mean_ms("render.view", "render.view") > 0

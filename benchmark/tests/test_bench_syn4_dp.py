"""The cells s2-eval.syn4 (kind `relight_eval`) and s1-train.dp4 (kind
`train_dp`): their metric readers on synthetic traces and spans, their
counts of work, their set-up, window and check run small on the CPU
(dp4 with two gloo ranks), faults planted in rank 0 of dp4 failing the
check, rank 0 of dp4 in the harness's own process, and on the card
(`cuda`) rank 0's memory reading.

s1-train.dp4 is not in BENCHMARK.json: on four H100s its rate spread
wider than half its bound. Here it takes the entries a benchmark change
would add (`with_dp4`)."""
import contextlib
import copy
import math

import pytest
import torch

from benchmark import harness, work, work_eval
from benchmark.faults import planted
from benchmark.trace import TraceData

SMALL = {"points": 2000, "width": 64, "height": 64, "train_views": 8,
         "sample_num": 8, "orbit_views": 10, "env_height": 32,
         "sample_range": 10, "trace_steps": 3, "trace_frames": 4,
         "ranks": 2}


DP4 = {"name": "s1-train.dp4", "config": "r3dg-nerfsyn-stage1",
       "traffic": "train-dp4", "chips": 4,
       "why": "cli.train --n_devices 4's stage-1 loop, 4 NCCL ranks on one "
              "host, one 800x800 view a rank a step, 300k points: the "
              "gradient all_reduce, the ranks' shared host"}
DP4_METRICS = (("dp.allreduce_device_ms.train", "ms", "device_trace"),
               ("dp.reduce_host_ms.train", "ms", "program_span"),
               ("dp.allreduce_bytes.train", "bytes", "program_counter"))


def with_dp4(bench: dict) -> dict:
    """`bench` with the cell s1-train.dp4: listed by every metric that
    lists s1-train, and by its three collectives' metrics."""
    bench = copy.deepcopy(bench)
    bench["workloads"].append(DP4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "s1-train" in m.get("workloads", []):
            m["workloads"].append(DP4["name"])
    bench["per_layer"] += [
        {"name": name, "unit": unit, "better": "lower", "source": source,
         "layer": "collectives", "moves": "train_views_per_s",
         "workloads": [DP4["name"]]} for name, unit, source in DP4_METRICS]
    return bench


@pytest.fixture(autouse=True)
def _dp4_entries(monkeypatch):
    spec = harness.spec
    monkeypatch.setattr(harness, "spec", lambda: with_dp4(spec()))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def read(name: str, t=None):
    return harness.metric_reader(name)(t)


def test_k6_roofline_reads_the_kernel_against_its_count():
    w = work_eval.k6_work(1000, 384, 16, 32)
    k6 = "void shade_eval_kernel(float const*)"
    t = TraceData(kind="frame", units=2, window_s=1.0,
                  device=[(k6, 0.0, 1e-3), ("composite_fwd_kernel<32>", 1e-3,
                                            2e-3), (k6, 2.0, 2.002)],
                  work=[{"k6": w}, {"k6": w}])
    want = 100 * work.bound_s(2 * w[0], 2 * w[1]) / 3e-3
    assert read("k6_roofline.eval", t) == pytest.approx(want)
    assert read("k6_roofline.eval", TraceData(kind="frame", units=1,
                                              window_s=1.0)) is None


def test_nccl_device_time_a_step():
    t = TraceData(kind="train", units=4, window_s=1.0, device=[
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0.0, 4e-4),
        ("composite_bwd_kernel", 4e-4, 1e-3),
        ("ncclDevKernel_AllReduce_Max_f32_RING_LL", 2e-3, 2.4e-3)])
    assert read("dp.allreduce_device_ms.train", t) == pytest.approx(0.2)
    assert read("dp.allreduce_device_ms.train",
                TraceData(kind="train", units=4, window_s=1.0)) is None


def test_span_readers_take_their_units():
    """The program-span and counter readers over records made under a
    profiler session: each a mean over the units of its top span."""
    from relightable3dgaussian_tpu_torch.utils import trace
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(3):
            with trace.span("eval.view", unit=True):
                trace.count("host.syncs", 2 + k)
                with trace.span("render.view"):
                    for name in ("render.projection", "render.binning"):
                        with trace.span(name):
                            pass
                with trace.span("eval.score"):
                    pass
        for _ in range(2):
            with trace.span("train.step", unit=True):
                with trace.span("dp.reduce"):
                    trace.count("dp.allreduce_bytes", 1000)
    for rec in trace.collect():            # CUDA events' reading, by hand
        if rec.name == "eval.score":
            rec.device_ms = 1.5
    assert read("host.syncs.view") == pytest.approx(3.0)
    for name in ("host.projection_ms.view", "host.binning_ms.view",
                 "host.render_self_ms.view"):
        assert read(name) > 0, name
        assert read(name.replace(".view", ".frame")) is None, name
    assert read("eval.score_device_ms.view") == pytest.approx(1.5)
    assert read("dp.allreduce_bytes.train") == pytest.approx(1000.0)
    assert read("dp.reduce_host_ms.train") > 0


def test_the_view_counts_add_their_pieces():
    # a 2x2 image: VGG16's first two stages see 2x2 and 1x1 pixels, the
    # rest none; K6 at P = 10, S = 4 on a 2 x 4 map without a transform.
    vgg = (2 * 3 * 64 * 9 * 4 + 2 * 64 * 4 + 2 * 64 * 64 * 9 * 4
           + 2 * 64 * 4 + 2 * 64 * 128 * 9 + 2 * 128
           + 2 * 128 * 128 * 9 + 2 * 128)
    assert work_eval.vgg_ops(2, 2) == vgg
    assert work_eval.score_ops(2, 2) == 4 * vgg + 2 * work.conv_ops(30, 2, 2,
                                                                    11)
    n_bytes, ops = work_eval.k6_work(10, 4, 2, 4)
    assert n_bytes == (10 * 4 * 5 + 10 * 58 + 2 * 4 * 3 + 10 * 19) * 4
    assert ops == 10 * 4 * work_eval.K6_OPS
    assert work_eval.view_ops(10, 4, 50, 20, 32, 2, 2) == (
        10 * work.PROJECTION_OPS + 50 * 15 + 20 * 67
        + 10 * 4 * work_eval.K6_OPS + work_eval.score_ops(2, 2))


def test_k6_count_is_the_kernels_own_layout():
    """k6_work's bytes are those of K6's inputs and outputs as
    ops/shading_eval_cuda.py lays them out (chip_smoke.py's count)."""
    from relightable3dgaussian_tpu_torch.models.lights import EnvLight
    from relightable3dgaussian_tpu_torch.ops import shading_eval_cuda as K6
    P, S, H, W = 7, 5, 4, 8
    x = (torch.rand(P, 3), torch.rand(P, 1), torch.rand(P, 3),
         torch.rand(P, 3), torch.rand(P, 16, 3),
         EnvLight(torch.rand(H, W, 3), torch.eye(3)), torch.rand(P, S, 1),
         torch.rand(P, S, 3), torch.rand(P, S, 1))
    ins = K6.kernel_inputs(*x)
    outs = P * (6 * 3 + 1) * 4
    assert work_eval.k6_work(P, S, H, W, transform=True)[0] == sum(
        t.numel() * t.element_size() for t in ins if t is not None) + outs


@pytest.mark.parametrize("cell", ["s2-eval.syn4", "s1-train.dp4"])
def test_the_cell_runs_small_and_correct(cell):
    r = harness.run_cell(cell, 2 ** 31 + 57, 0.3, False, device="cpu",
                         overrides=SMALL)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and list(r)[-1] == "checks"
    if cell == "s1-train.dp4":
        assert r["checks"]["replicas_apart"]["value"] == 0


@pytest.mark.parametrize("cell,mine", [
    ("s2-eval.syn4", {"host.syncs.view", "host.aten_ops.frame",
                      "device.idle_share.frame", "mfu.frame",
                      "host.projection_ms.view", "host.binning_ms.view",
                      "host.render_self_ms.view"}),
    ("s1-train.dp4", {"dp.reduce_host_ms.train", "dp.allreduce_bytes.train",
                      "host.aten_ops.train", "host.syncs.train",
                      "host.optimizer_ms.train", "mfu.train"})])
def test_a_traced_run_reports_the_new_layers(cell, mine):
    """On the CPU the readings of the card (CUDA events, kernels by name)
    are absent; the others are there."""
    r = harness.run_cell(cell, 2 ** 31 + 59, 0.3, True, device="cpu",
                         overrides=SMALL)
    assert r["correct"], r["checks"]
    assert mine <= set(r["metrics"]), set(r["metrics"])
    for name in ("eval.score_device_ms.view", "k6_roofline.eval",
                 "dp.allreduce_device_ms.train"):
        assert name not in r["metrics"]
    if cell == "s1-train.dp4":
        steps = r["metrics"]["dp.allreduce_bytes.train"]["value"]
        # every gradient, the four statistics and the radii, the metrics
        assert steps > (62 + 5) * 4 * SMALL["points"]


@contextlib.contextmanager
def skipped_all_reduce():
    """Rank 0 takes part in every all_reduce but keeps its own tensor, as
    if it had skipped the reduction."""
    from relightable3dgaussian_tpu_torch.parallel import data_parallel as dp
    real = dp.all_reduce_

    def own(tensor, group, op="sum"):
        real(tensor.clone(), group, op)
        return tensor

    dp.all_reduce_ = own
    try:
        yield
    finally:
        dp.all_reduce_ = real


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "skipped_all_reduce"])
def test_a_broken_rank_0_is_not_correct(fault):
    """A fault planted in rank 0 alone (the harness's process; the other
    rank runs the program whole): Adam's step a no-op, the loss over half
    the view, or the reduction skipped. Rank 0's steps are the ones
    checked."""
    with (skipped_all_reduce() if fault == "skipped_all_reduce"
          else planted(fault)):
        r = harness.run_cell("s1-train.dp4", 2 ** 31 + 67, 0.3, False,
                             device="cpu", overrides=SMALL)
    assert not r["correct"], (fault, r["checks"])


def test_rank_0_is_the_harness_process():
    """Set-up joins the group as rank 0 in this process (so that the
    harness's memory reading and profiler see rank 0's work), the other
    ranks in processes of their own; release leaves it."""
    import torch.distributed as dist
    _, _, kind, st = harness.setup_cell("s1-train.dp4", 2 ** 31 + 61,
                                        device="cpu", overrides=SMALL)
    try:
        assert dist.is_initialized() and dist.get_rank() == 0
        assert dist.get_world_size() == SMALL["ranks"]
        assert st.model.xyz.device.type == "cpu"
        kind.window(st, 0.2, False)
    finally:
        kind.release(st)
    assert not dist.is_initialized()


@pytest.mark.cuda
def test_rank_0_memory_is_read_on_the_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: the harness reads the memory "
                    "of each card the cell asks for")
    r = harness.run_cell("s1-train.dp4", 2 ** 31 + 63, 1.0, False,
                         overrides=dict(SMALL, ranks=4))
    assert r["correct"], r["checks"]
    assert r["device"]["memory_peak_bytes"] > 0
    assert math.isfinite(r["metrics"]["train_views_per_s"]["value"])

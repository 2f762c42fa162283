"""The per-layer metrics read from the program's own spans and counters
(`relightable3dgaussian_tpu_torch/utils/trace.py`): a traced run of every
cell, small on the CPU and one after another in one process, reports each
such metric its entry lists for the cell, from that cell's own units. The
device interval of a span is a card's reading: on the CPU it is not
reported."""
import pytest
import torch

from benchmark import harness
from test_bench_cells import CELLS, SMALL, TRAIN

SPEC = harness.spec()
PROGRAM = [m for m in SPEC["per_layer"]
           if m["source"] in ("program_span", "program_counter")
           and not m["name"].startswith("train.")]
DEVICE_ONLY = {"shading.eval_device_ms.frame"}


@pytest.fixture(scope="module")
def traced():
    """Each cell's traced result, and the units its records hold (top span
    name -> count), the cells run in BENCHMARK.json's order."""
    from relightable3dgaussian_tpu_torch.utils import trace
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    out = {}
    try:
        for cell in CELLS:
            r = harness.run_cell(cell, 2 ** 31 + 31, 0.3, True, device="cpu",
                                 overrides=SMALL)
            records = trace.collect()
            tops = {}
            for rec in records:
                if rec.parent is None and rec.unit is not None:
                    tops[rec.name] = tops.get(rec.name, 0) + 1
            out[cell] = (r, tops)
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_program_metrics(traced, cell):
    r, _ = traced[cell]
    assert r["correct"], r["checks"]
    mine = [m["name"] for m in PROGRAM if cell in m["workloads"]]
    assert mine
    for name in mine:
        if name in DEVICE_ONLY:
            assert name not in r["metrics"]
            continue
        assert name in r["metrics"], name
        assert r["metrics"][name]["value"] >= 0, name
    others = {m["name"] for m in PROGRAM} - set(mine)
    assert not others & set(r["metrics"])


def test_each_cell_reads_only_its_own_units(traced):
    for cell in CELLS:
        r, tops = traced[cell]
        want = ({"train.step": SMALL["trace_steps"]} if cell in TRAIN
                else {"render.view": SMALL["trace_frames"]})
        assert tops == want, (cell, tops)
        assert r["attempted"] == sum(want.values())

"""Every cell run small on the CPU through the harness (the look for a
card skipped; the port's plain versions in place of its kernels), correct
against the reference; then with the timed path broken underneath, once for
each fault the cell can have, `correct` false. On the card (`cuda`): the
control, the reference in float32 with TF32 put in the program's place,
fails a limit at a size a test run holds."""
import json

import pytest
import torch

from benchmark import calibrate, checks, harness
from benchmark.faults import planted

SMALL = {"points": 2000, "width": 64, "height": 64, "train_views": 8,
         "sample_num": 8, "orbit_views": 10, "env_height": 32,
         "sample_range": 10, "trace_steps": 3, "trace_frames": 4}
CELLS = [w["name"] for w in harness.spec()["workloads"]]
TRAIN = [c for c in CELLS if harness.cell_files(harness.spec(), c)[2]["kind"]
         == "train"]
FRAMES = [c for c in CELLS if c not in TRAIN]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_small(cell):
    r = harness.run_cell(cell, 2 ** 31 + 17, 0.3, False, device="cpu",
                         overrides=SMALL)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] > 0
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_its_layers(cell):
    r = harness.run_cell(cell, 2 ** 31 + 23, 0.3, True, device="cpu",
                         overrides=SMALL)
    assert r["correct"] and r["metrics"]
    assert "aten_ops" in " ".join(r["metrics"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell,fault",
                         [(c, f) for c in TRAIN for f in ("unchanged",
                                                          "half_batch")]
                         + [(c, "altered") for c in FRAMES])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    with planted(fault):
        r = harness.run_cell(cell, 2 ** 31 + 29, 0.3, False, device="cpu",
                             overrides=SMALL)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    size = dict(points=30_000, width=400, height=400, sample_num=16)
    lim = checks.limits(cell)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        rows = calibrate.readings(cell, seed, 0.5, True, None,
                                  overrides=size)
        control = next(r["numbers"] for r in rows if r["side"] == "control")
        assert any(v > lim[k] for k, v in control.items()), control


def test_frame_cells_fix_the_heap():
    """The frame kinds set both malloc thresholds, so that a frame's host
    image costs the same whatever the heap's history."""
    from benchmark.kinds import common
    assert common.fixed_heap()
    assert common.fixed_heap()

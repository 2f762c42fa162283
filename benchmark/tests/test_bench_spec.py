"""BENCHMARK.json against the benchmark's contract, and the harness finding
every cell, configuration, traffic mix, limit and metric by name."""
import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(SPEC) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["paths"]) <= 16
    assert len(SPEC["command"]) <= 32
    for w in SPEC["command"]:
        assert _one_line(w) and not w.startswith("/") and ".." not in w


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_allowed_and_unique(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["why"]) and _one_line(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _one_line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for w in SPEC["workloads"]:
        mine = [m["name"] for m in harness.cell_metrics(SPEC, w["name"],
                                                         "end_to_end")]
        assert "setup_s" in mine and len(mine) >= 2
        assert harness.cell_metrics(SPEC, w["name"], "per_layer")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
            reported = [x["name"] for x in harness.cell_metrics(
                SPEC, cell, "end_to_end")]
            assert m["moves"] in reported, (m["name"], cell)


def test_kernel_shares_are_named_and_in_percent():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


def test_harness_finds_every_file_by_name():
    configs = {c["name"] for c in SPEC["configs"]}
    used = {w["config"] for w in SPEC["workloads"]}
    assert configs == used
    for c in SPEC["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.is_relative_to(ROOT / "benchmark")
        assert json.loads(path.read_text())["name"] == c["name"]
    for w in SPEC["workloads"]:
        entry, config, traffic = harness.cell_files(SPEC, w["name"])
        assert harness.kind_module(traffic).setup
        lim = json.loads((ROOT / "benchmark" / "limits"
                          / f"{w['name']}.json").read_text())["limits"]
        assert lim and all(v > 0 for v in lim.values())
    for m in SPEC["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_paths_hold_the_benchmark_only():
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert (ROOT / p).is_dir() and not p.endswith("_torch")

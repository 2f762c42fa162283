"""The benchmark's driver: finds a cell by name in BENCHMARK.json, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`, whose `kind` names the general generator
`kinds/<kind>.py`), its limits (`limits/<cell>.json`) and its per-layer
metrics (`metrics/<metric>.py`), runs set-up, the measured window and the
check, and prints the result as the last line of standard output.

A kind module gives `setup(ctx) -> state`, `window(state, seconds, trace)
-> Window`, `release(state)` (frees the program's state once the window
has closed) and `check(state) -> {number: value}`. A later cell, traffic
mix or metric is a new file and a new entry; nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

_T0 = time.perf_counter()        # this module loads as the process starts
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "relightable3dgaussian_tpu")
CACHE = ROOT / "build" / "benchmark_cache"


@dataclass
class Window:
    units: int                   # steps or frames completed in the window
    window_s: float
    end_to_end: dict             # metric name -> value, taken by the kind
    failed: int = 0
    trace: object = None         # trace.TraceData with --trace 1


@dataclass
class Context:
    cell: str
    seed: int
    config: dict
    traffic: dict
    chips: int
    device: object


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_files(bench: dict, name: str, overrides: dict | None = None):
    """(entry, configuration, traffic) of cell `name`; `overrides` replaces
    keys of the configuration and the traffic (tests run cells small)."""
    entry = cell_entry(bench, name)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    for k, v in (overrides or {}).items():
        (config if k in config else traffic)[k] = v
    return entry, config, traffic


def kind_module(traffic: dict):
    return importlib.import_module(f"benchmark.kinds.{traffic['kind']}")


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec_ = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str, group: str) -> list[dict]:
    """The metrics of `group` ("end_to_end" or "per_layer") this cell
    reports: those without a `workloads` key and those that list it."""
    return [m for m in bench[group]
            if "workloads" not in m or cell in m["workloads"]]


def phase(name: str) -> None:
    """Note on standard error when a set-up phase ended, in seconds since
    the harness was loaded: the set-up's breakdown."""
    print(f"[setup] {name} at {time.perf_counter() - _T0:.2f} s",
          file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fixed_caches() -> None:
    """Every build and kernel cache the program or torch may write, at
    fixed paths inside the checkout (the kernels themselves build into the
    port's `build/torch_kernels/`)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    # K2 is the backward the cells measure; K5 only under this switch.
    os.environ.pop("R3DG_BWD_TWO_WALK", None)


def device_info(chips: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def setup_cell(name: str, seed: int, *, device=None,
               overrides: dict | None = None):
    """(bench, entry, kind module, state) of cell `name` after set-up.
    `device` None means the card."""
    bench = spec()
    entry, config, traffic = cell_files(bench, name, overrides)
    import torch
    phase("torch loaded")
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        phase("the card's context")
    ctx = Context(cell=name, seed=seed, config=config, traffic=traffic,
                  chips=entry["chips"], device=dev)
    kind = kind_module(traffic)
    import relightable3dgaussian_tpu_torch  # noqa: F401  (the program)
    phase("the program loaded")
    state = kind.setup(ctx)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return bench, entry, kind, state


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device=None, overrides: dict | None = None,
             t_start: float | None = None) -> dict:
    """Set-up, window and check of cell `name`; returns the result line's
    object (with "checks" last). `device` None means the card."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench, entry, kind, state = setup_cell(name, seed, device=device,
                                           overrides=overrides)
    setup_s = time.perf_counter() - t_start
    win = kind.window(state, seconds, trace)
    leaked = forbidden_modules()
    if leaked:
        raise SystemExit(f"loaded after the window: {', '.join(leaked)}")
    dev_info = (device_info(entry["chips"]) if device is None else
                {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": 0})
    kind.release(state)
    from . import checks
    ok, shown = checks.judge(kind.check(state), checks.limits(name))
    result = {"correct": ok, "attempted": win.units, "failed": win.failed}
    if trace:
        from .trace import breakdown
        t = win.trace
        metrics = {}
        for m in cell_metrics(bench, name, "per_layer"):
            value = metric_reader(m["name"])(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = t.busy_s
        dev_info["window_s"] = t.window_s
        result["metrics"] = metrics
        result["device"] = dev_info
        result["breakdown"] = breakdown(t)
    else:
        values = dict(win.end_to_end, setup_s=setup_s,
                      peak_mem_gib=dev_info["memory_peak_bytes"] / 2 ** 30)
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell_metrics(bench, name, "end_to_end")}
        result["device"] = dev_info
    result["checks"] = shown
    return result


def main(argv=None) -> int:
    import argparse
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fixed_caches()
    bench = spec()
    chips = cell_entry(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    leaked = forbidden_modules()
    if leaked:
        print(f"loaded in this process: {', '.join(leaked)}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

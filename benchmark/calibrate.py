"""The readings a cell's limits are set from, on the card, in one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds a,b,... \
        [--control-seeds ...] [--fault <name> --fault-seeds ...] [--seconds s]

For each seed, set-up and a short window at the cell's own size, then the
numbers of `checks.py` for the program against the float64 reference; on
the control seeds also the control (the reference in float32 with TF32,
put in the program's place) against it; with --fault, the program with the
fault of `faults.py` planted. One JSON line a reading, then a summary: the
largest program reading, the smallest control and fault readings of each
number. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys


def readings(cell: str, seed: int, seconds: float, control: bool,
             fault: str | None, device=None, overrides=None) -> list[dict]:
    from . import harness
    from .faults import planted
    with planted(fault):
        _, _, kind, st = harness.setup_cell(cell, seed, device=device,
                                            overrides=overrides)
        kind.window(st, seconds, False)
    kind.release(st)
    ref = kind.readings(st)
    out = [{"seed": seed, "side": fault or "program",
            "numbers": kind.compare(st, ref, kind.program_side(st))}]
    if control:
        out.append({"seed": seed, "side": "control", "numbers": kind.compare(
            st, ref, kind.readings(st, control=True))})
    del st, ref
    import gc
    gc.collect()
    return out


def summary(rows: list[dict]) -> dict:
    out: dict = {}
    for r in rows:
        side = "program" if r["side"] == "program" else r["side"]
        for k, v in r["numbers"].items():
            agg = max if side == "program" else min
            key = (side, k)
            out[key] = v if key not in out else agg(out[key], v)
    return {f"{s}.{k}": v for (s, k), v in sorted(out.items())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    from .harness import fixed_caches
    fixed_caches()
    ints = lambda s: [int(x) for x in s.split(",") if x]
    controls = set(ints(args.control_seeds))
    rows = []
    for seed in ints(args.seeds) + [s for s in controls
                                    if s not in ints(args.seeds)]:
        for r in readings(args.workload, seed, args.seconds,
                          seed in controls, None):
            rows.append(r)
            print(json.dumps(r), flush=True)
    for seed in ints(args.fault_seeds):
        for r in readings(args.workload, seed, args.seconds, False,
                          args.fault):
            rows.append(r)
            print(json.dumps(r), flush=True)
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""chip_smoke.py's multi-card phases alone, on every card of the machine.

    python3 examples/multi_card.py

Runs the phases the parallel and cli-ranks phases start from (build, the
stage-1 train and stage-2 phases at 800x800 from the 100k-gaussian scene,
the cli phase's commands and the relight phase's composition), then
chip_smoke.parallel_phases (dp-stage1, dp-stage2 and sharded at each rank
layout of dp_layouts: with two or more cards one rank a card over NCCL at
1, 2 and min(count, 4) ranks, with one card two gloo ranks on it, and the
parallel-scaling line) and, with two or more cards, chip_smoke.
cli_ranks_phase (the CLIs at --n_devices min(count, 4)). It leaves out
chip_smoke's other checks and profiles, so a multi-card machine is held
only as long as these phases need. Prints the card's name and power limit,
the interconnect line and each phase's line; exits non-zero on any
failure. Needs NVIDIA GPUs and nvcc.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: needs NVIDIA GPUs")
    t0 = time.perf_counter()
    device = torch.device("cuda:0")
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.print_interconnect()
    print(cs.CARD, flush=True)
    cs.build_phase()
    scene = cs.GaussianModel.from_numpy(cs.make_scene(cs.N_MAIN, cs.SEED),
                                        device=device)
    trained = cs.train_phase(scene, cs.SIZE_MAIN, cs.VIEWS, cs.N_INIT,
                             cs.TRAIN_OPT, device)
    s2 = cs.stage2_phase(trained, device)
    cli = cs.cli_phase(scene, device)
    relight = cs.relight_phase(s2, cli, device)
    cs.parallel_phases(trained, s2, device)
    if torch.cuda.device_count() >= 2:
        cs.cli_ranks_phase(cli, relight, device)
    cs.say("multi-card", cards=torch.cuda.device_count(),
           wall_s=f"{time.perf_counter() - t0:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

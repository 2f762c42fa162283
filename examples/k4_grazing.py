"""K4 at grazing views against float64, on the card.

    python3 examples/k4_grazing.py

On chip_smoke.py's seeded K4 inputs (20,000 points, 64 samples), the view
direction of the first 200 points is set at V.N = +-eps (alternating signs)
for eps from 0 to 2e-6, and chip_smoke.check_k4 holds K4 forward and
backward against the plain shading in float64 (three seeds each), under
k4-main's gate. The shading turns each normal to the viewer's side by
sign(V.N): where K4's float32 sign and float64's disagree, or K4 finds V.N
exactly 0, the point's shading is another function, and the gate leaves
such points out; it prints each field that would fail with them in, with
the worst points (their view-normal cosine in float32 and float64, K4's
sign, and K4's, the plain and the float64 values there), and fails on a
disagreement outside them. Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

GRAZING, P, S = 200, 20_000, 64


def main() -> None:
    dev = torch.device("cuda:0")
    cs.build_phase()
    for eps in (0.0, 1e-9, 1e-8, 5e-8, 1e-7, 5e-7, 1e-6, 2e-6):
        for seed in range(3):
            x = list(cs.shading_case(P, S, 100 + seed, dev))
            n, v = x[2][:GRAZING], x[3].clone()
            g = torch.Generator().manual_seed(seed)
            t = torch.linalg.cross(n, torch.randn((GRAZING, 3),
                                                  generator=g).to(dev))
            t = t / t.norm(dim=-1, keepdim=True)
            sign = 1.0 - 2.0 * (torch.arange(GRAZING, device=dev) % 2)
            w = t + (sign * eps)[:, None] * n
            v[:GRAZING] = w / w.norm(dim=-1, keepdim=True)
            x[3] = v.contiguous()
            try:
                cs.check_k4(tuple(x), f"k4-grazing eps={eps} seed={seed}",
                            seed, reps=1, plain_reps=1)
            except AssertionError as e:
                print("FAIL", e, flush=True)


if __name__ == "__main__":
    main()

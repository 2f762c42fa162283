"""The float64 reference at VoH's lower clip, on chip_smoke's voh-clip inputs.

    python3 examples/k4_voh_reference.py

chip_smoke.k4_branch_case("voh-clip") puts VoH of each point's last sample
at 1e-6 (1 + delta) in float64, |delta| each of chip_smoke.K4_BRANCH_DELTAS
in both signs: a sample a few 1e-4 off the opposite of the view, where
VoH = (1 + V.d) / |d + V| reaches 1e-6 only because |d| > 1, so 1 + V.d
cancels to ~3e-10. This prints float64's VoH against exact arithmetic
(Python decimals, 60 digits, from the same float32 inputs): its largest
error in units of 1e-6, and per |delta| how many samples float64 decides
the clip otherwise. With a card, it then holds K4's view-direction
gradient (a seeded cotangent, as the k4-branches phase draws it) against
the plain shading in float64 computed on the card and on the CPU, the
two references against each other, and K4 against check_k4's reference
(float64 with VoH's clip decided exactly where K4 takes it past float64,
chip_smoke.reference_voh_pass), each in units of the field's largest
entry: on the k4-branches phase's inputs, and on examples/
k4_conditioning.py's voh-clip runs (three seeds at each |delta| up to
1e-5, their cotangents). The CPU part needs no card; the card part needs
an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from relightable3dgaussian_tpu_torch.ops import shading_cuda  # noqa: E402
from relightable3dgaussian_tpu_torch.ops.shading import ggx_terms  # noqa: E402

CASE = "voh-clip"
I_CASE = cs.K4_BRANCH_CASES.index(CASE)


def view_grad(x, cot, device, voh_pass=None) -> torch.Tensor:
    """The plain shading's view-direction gradient in float64 on `device`
    (VoH's clip decided by `voh_pass` where given)."""
    x64 = [t.to(device).double() for t in x]
    with torch.enable_grad():
        leaves, loss = cs.plain_shading_graph(
            x64, [c.to(device).double() for c in cot],
            None if voh_pass is None else voh_pass.to(device))
        return torch.autograd.grad(loss, leaves)[2].cpu()


def main() -> None:
    x, delta, _ = cs.k4_branch_case(CASE, cs.K4_BRANCH_P, cs.SAMPLE_NUM,
                                    cs.SEED + 500 + I_CASE, "cpu")
    vdir, d = x[3].numpy(), x[7][:, -1].numpy()
    exact = np.array([float(cs.exact_voh(vdir[i], d[i]))
                      for i in range(len(vdir))])
    f64 = ggx_terms(x[2].double(), x[3].double(), x[7][:, -1:].double(),
                    x[1].double())["VoH"].reshape(-1).numpy()
    print(f"[k4-voh-reference] float64_voh_err_max="
          f"{np.abs(f64 - exact).max() / 1e-6:.3e} (units of 1e-6)",
          flush=True)
    for dl in cs.K4_BRANCH_DELTAS:
        m = np.isclose(np.abs(delta), dl)
        apart = int(((f64[m] >= 1e-6) != (exact[m] >= 1e-6)).sum())
        print(f"[k4-voh-reference] delta={dl:g} "
              f"float64_decisions_apart_from_exact={apart} of {int(m.sum())}",
              flush=True)
    if not torch.cuda.is_available():
        return
    dev = torch.device("cuda:0")
    print(f"[k4-voh-reference] {torch.cuda.get_device_name(0)}", flush=True)
    compare(tuple(t.to(dev) for t in x), cs.SEED + 510 + I_CASE,
            "k4-branches", dev)
    for dl in [d for d in cs.K4_BRANCH_DELTAS if d <= 1e-5]:
        for seed in range(3):          # as examples/k4_conditioning.py
            x, _, _ = cs.k4_branch_case(CASE, 2000, cs.SAMPLE_NUM,
                                        600 + seed, dev, (dl,))
            compare(x, seed, f"conditioning delta={dl:g} seed={seed}", dev)


def compare(x, cot_seed: int, label: str, dev) -> None:
    """K4's view-direction gradient against float64 on the card and on
    the CPU, for check_k4's cotangent of `cot_seed`."""
    P = x[0].shape[0]
    gen = torch.Generator().manual_seed(cot_seed)
    cot = [torch.randn((P, 3), generator=gen).to(dev) for _ in range(3)]
    got = shading_cuda.shade_bwd(*shading_cuda.kernel_inputs(*x),
                                 *cot)[2].cpu().double()
    card, host = view_grad(x, cot, dev), view_grad(x, cot, "cpu")
    voh_pass, _ = cs.reference_voh_pass(x)
    ref = view_grad(x, cot, "cpu", voh_pass)
    scale = float(host.abs().max())

    def err(a, b):
        return f"{float((a - b).abs().max()) / scale:.3e}"

    print(f"[k4-voh-reference] {label} k4_vs_card_float64={err(got, card)} "
          f"k4_vs_cpu_float64={err(got, host)} "
          f"card_float64_vs_cpu_float64={err(card, host)} "
          f"k4_vs_exact_decision_reference={err(got, ref)}", flush=True)


if __name__ == "__main__":
    main()

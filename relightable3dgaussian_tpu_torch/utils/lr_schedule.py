"""Learning-rate schedules (port of relightable3dgaussian_tpu/utils/lr_schedule.py)."""
from __future__ import annotations

import math


def expon_lr(step, lr_init: float, lr_final: float, max_steps: int) -> float:
    """Log-linear interpolation from lr_init to lr_final over max_steps (the
    reference's exponential position schedule). Its delayed warm-up is not
    ported: the stage-1 schedule sets no delay steps, so it never applies."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0   # the reference's disabled schedule
    t = min(max(float(step) / max_steps, 0.0), 1.0)
    return math.exp(math.log(max(lr_init, 1e-30)) * (1 - t)
                    + math.log(max(lr_final, 1e-30)) * t)

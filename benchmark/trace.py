"""Reading a torch.profiler trace of the measured window into what the
per-layer metrics read: device activity by name, host ops, the device's
busy time (the union of its activity intervals), the idle gaps labelled by
what the host was doing, and the counted work of each traced step or
frame. Kernel names, not launch counts the program keeps, find a kernel's
device time.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from .work import FP32_FLOPS_PER_S, bound_s

# The device kernels of the port, by the symbol the profiler names them by.
KERNELS = {
    "k1": "composite_fwd_kernel",
    "k2": "composite_bwd_kernel",
    "k3": "trace_kernel",
    "k4": ("shade_fwd_kernel", "shade_bwd_kernel", "shade_bwd_fix_kernel"),
}


@dataclass
class TraceData:
    """One traced window. Times in seconds; `device` and `host` hold
    (name, start, end) in the profiler's clock (seconds)."""
    kind: str                                   # "train" or "frame"
    units: int                                  # steps or frames traced
    window_s: float
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    step_split: list = field(default_factory=list)   # StepTimer's, ms
    work: list = field(default_factory=list)    # per unit: {piece: (bytes, ops)}

    def kernel_s(self, key: str) -> float:
        """Device seconds of the kernels of `key` (KERNELS) in the window."""
        names = KERNELS[key]
        names = (names,) if isinstance(names, str) else names
        return sum(e - s for n, s, e in self.device
                   if any(k in n for k in names))

    def device_s_matching(self, *parts: str) -> float:
        """Device seconds of the ops whose name holds every part."""
        return sum(e - s for n, s, e in self.device
                   if all(p in n for p in parts))

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in busy_intervals(self.device))

    def aten_ops(self) -> int:
        return sum(1 for n, _, _ in self.host if n.startswith("aten::"))

    def work_sum(self, piece: str) -> tuple[float, float] | None:
        """(bytes, ops) of `piece` summed over the traced units, or None
        where no unit counted it."""
        got = [w[piece] for w in self.work if piece in w]
        if not got:
            return None
        return (float(sum(b for b, _ in got)), float(sum(o for _, o in got)))

    def roofline(self, piece: str, kernel: str) -> float | None:
        """100 x the least time the H100 needs for the counted work of
        `piece` over the device time of `kernel`'s launches (None where
        nothing was counted or the kernel did not run)."""
        counted, dev = self.work_sum(piece), self.kernel_s(kernel)
        if counted is None or dev <= 0:
            return None
        return 100.0 * bound_s(*counted) / dev

    def mfu(self, piece: str) -> float | None:
        """100 x the counted FP32 operations of `piece` over what the
        window's time allows at the FP32 peak."""
        counted = self.work_sum(piece)
        if counted is None or self.window_s <= 0:
            return None
        return 100.0 * counted[1] / (self.window_s * FP32_FLOPS_PER_S)


def from_profiler(prof) -> tuple[list, list]:
    """(device events, host events) of a stopped torch.profiler.profile, as
    (name, start_s, end_s) sorted by start."""
    import torch
    device, host = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if getattr(e, "is_user_annotation", False):
            continue     # a host range's shadow on the device, not activity
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(span)
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append(span)
    return sorted(device, key=lambda x: x[1]), sorted(host, key=lambda x: x[1])


def busy_intervals(device: list) -> list[tuple[float, float]]:
    """The union of the device's activity intervals, merged, in order."""
    out: list[list[float]] = []
    for _, s, e in sorted(device, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def host_label(host: list, starts: list, t: float, look_back: int = 4096) -> str:
    """The innermost host op running at time t (the latest-starting one that
    covers it), or "python" where none does."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 1 - look_back), -1):
        name, s, e = host[j]
        if e >= t:
            best = name
            break
    return best or "python"


def breakdown(t: TraceData, top: int = 10) -> dict:
    """The device ops that took most time, and the idle time between the
    device's busy intervals by what the host was doing at each gap's
    middle, each list the `top` largest [name, seconds]."""
    by_op: dict[str, float] = {}
    for n, s, e in t.device:
        by_op[n] = by_op.get(n, 0.0) + (e - s)
    busy = busy_intervals(t.device)
    starts = [s for _, s, _ in t.host]
    gaps: dict[str, float] = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        if b > a:
            label = host_label(t.host, starts, 0.5 * (a + b))
            gaps[label] = gaps.get(label, 0.0) + (b - a)
    order = sorted(by_op.items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in order],
            "idle_gaps": [[n[:120], s] for n, s in
                          sorted(gaps.items(), key=lambda x: -x[1])[:top]]}

"""Wall-clock timing that waits for the device (port of
relightable3dgaussian_tpu/utils/timing.py).

`Timing` is the reference's CUDA-event `Timing` context manager
(utils/system_utils.py:67-87) on the host clock: it synchronizes the card
before and after the block, where the JAX package waits with
`effects_barrier`. `time_fn` is the median of `iters` calls after `warmup`,
each ended by a synchronize, where the JAX package blocks on the outputs.
Work on the CPU finishes before it returns, so nothing is waited for there.
"""
from __future__ import annotations

import time

import torch


def synchronize(device: torch.device | str | None = None) -> None:
    """Wait for the work queued on `device`: a CUDA device is synchronized;
    the CPU (and None without a card) has nothing to wait for."""
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timing:
    """Context manager printing the elapsed milliseconds of its block, the
    device's work included.

    with Timing("render"):
        out = render(...)

    `device` is the device of the work (by default every initialized card).
    `elapsed_ms` holds the time after the block; `[timing] name: x.xxx ms`
    is printed when `name` is given and `enabled`.
    """

    def __init__(self, name: str = "", enabled: bool = True,
                 device: torch.device | str | None = None):
        self.name = name
        self.enabled = enabled
        self.device = device
        self.elapsed_ms = None

    def __enter__(self):
        if self.enabled:
            synchronize(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            synchronize(self.device)
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        if self.enabled and self.name:
            print(f"[timing] {self.name}: {self.elapsed_ms:.3f} ms")
        return False


def time_fn(fn, *args, warmup: int = 1, iters: int = 10,
            device: torch.device | str | None = None, **kwargs) -> float:
    """Median wall time of `fn(*args, **kwargs)` in milliseconds over
    `iters` calls after `warmup`, each call's device work included."""
    for _ in range(warmup):
        fn(*args, **kwargs)
        synchronize(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]

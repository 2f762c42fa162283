"""The port's tracer: spans at its layer boundaries, and counters.

A span (`span(name)`) is on exactly while a `torch.profiler` session is
recording (`torch.autograd._profiler_enabled()`). It then opens
`torch.profiler.record_function(name)`, so it shows in the profiler's
timeline and chrome trace beside the kernels, and keeps a `Record` in
memory: its name, its parent span, its unit (the step or frame it belongs
to), and its host start and end in unix nanoseconds (`time.time_ns()`,
taken inside the profiler's range: the clock of the profiler's events and
of its `trace_start_ns`). On CUDA a span that asks for it also carries a
pair of CUDA events, read when the records are collected, never inside
the step. Off, a span costs one check and returns the shared `NULL`
context: no timestamp, no event, no host sync.

The records are those of the last profiling session. A span that finds
the profiler off, or a `collect()`, ends the session; the next span under
the profiler starts an empty one. Parents are kept per thread: a span
opened on a thread with none open (the autograd engine's worker running a
backward on the card) takes the innermost span open elsewhere as its
parent, and its unit.

The program's spans: `train.step` (a unit), `train.forward`,
`train.backward` and `train.optimizer` (their device events are
`StepTimer`'s when the step has one), `train.loss`, `render.view` (a unit
where no step is open), `render.projection`, `render.binning` and
`render.shading` (with device events), `eval.view` (a unit: one scored
view of `cli/eval_relighting_syn4.py::relight_view`), `eval.score` (with
device events: its PSNR, SSIM and LPIPS) and `dp.reduce` (the
data-parallel combination between a rank's backward and its optimizer
step, `parallel/data_parallel.py::reduce_step`). `unit_mean_ms`,
`unit_mean_device_ms` and `unit_mean_count` are what the benchmark's
per-layer metrics read.

Counters (`count(name)`) are plain integers under dotted names, counted
where the work happens whether tracing is on or off: the kernels' launches
(`k1.launches`, `k2.launches`, `k5.launches`, `k3.launches`,
`k4.launches`, `k4.bwd_launches`, `k6.launches`, `env.lookup_launches`,
`env.lookup_bwd_launches`, `env.bwd_private`; each counted by its
`ops/_build.py::Entry`, the last by its wrapper), `lpips.forwards` (the
images through LPIPS's backbone), `dp.allreduce_bytes` (the bytes each
data-parallel all_reduce reduces on this rank) and `host.syncs`, each
point where the hot path waits for the device (a value read back, a
masked selection's size, a copy from pageable host memory, which waits for
the stream), counted where it is on any device.
"""
from __future__ import annotations

import threading
import time

import torch


class Record:
    """One span of the last profiling session. `parent` is the parent's
    index in `collect()`'s list (None at the top); `unit` the step or frame
    it belongs to (None outside any); times in unix nanoseconds;
    `device_ms` the CUDA events' interval once collected; `counts` (a unit's
    top span only) what each counter counted inside it."""
    __slots__ = ("name", "index", "parent", "unit", "start_ns", "end_ns",
                 "events", "device_ms", "counts")

    def __init__(self, name: str, index: int, parent: Record | None):
        self.name = name
        self.index = index
        self.parent = None if parent is None else parent.index
        self.unit = None if parent is None else parent.unit
        self.start_ns = self.end_ns = None
        self.events = self.device_ms = self.counts = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class _Null:
    """What `span` returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def events(self, start, end) -> None:
        pass


NULL = _Null()

_lock = threading.Lock()
_local = threading.local()        # .stack: this thread's open records
_records: list[Record] = []
_session_over = True
_units = 0
_open: Record | None = None       # the innermost span open on any thread
_counters: dict[str, int] = {}


def span(name: str, *, unit: bool = False, device: torch.device | None = None):
    """A context manager around one layer's work. With `unit`, a span with
    no parent starts a new unit (a step or a frame). With `device` a CUDA
    device, the span records CUDA events around its work there."""
    global _session_over
    if not torch.autograd._profiler_enabled():
        _session_over = True
        return NULL
    return _Span(name, unit, device is not None and device.type == "cuda")


class _Span:
    __slots__ = ("_name", "_unit", "_cuda", "_rf", "_record", "_parent",
                 "_before")

    def __init__(self, name: str, unit: bool, cuda: bool):
        self._name, self._unit, self._cuda = name, unit, cuda
        self._before = None

    def __enter__(self):
        global _records, _session_over, _units, _open
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        with _lock:
            if _session_over:
                _records, _session_over, _units = [], False, 0
            parent = stack[-1] if stack else _open
            if parent is not None and (
                    parent.index >= len(_records)
                    or _records[parent.index] is not parent):
                parent = None             # open since an earlier session
            rec = Record(self._name, len(_records), parent)
            if self._unit and parent is None:
                _units += 1
                rec.unit = _units
                self._before = dict(_counters)
            _records.append(rec)
            _open = rec
        stack.append(rec)
        self._record, self._parent = rec, parent
        rec.start_ns = time.time_ns()
        if self._cuda:
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        return self

    def events(self, start: torch.cuda.Event, end: torch.cuda.Event) -> None:
        """Take `start` and `end`, recorded by the caller around this
        span's work, as its device events."""
        self._record.events = (start, end)

    def __exit__(self, *exc) -> bool:
        global _open
        rec = self._record
        if self._cuda:
            rec.events[1].record()
        rec.end_ns = time.time_ns()
        _local.stack.pop()
        with _lock:
            if self._before is not None:
                rec.counts = {k: v - self._before.get(k, 0)
                              for k, v in _counters.items()
                              if v != self._before.get(k, 0)}
            if _open is rec:
                _open = self._parent
        self._rf.__exit__(*exc)
        return False


def collect() -> list[Record]:
    """The records of the last profiling session, their CUDA events read
    (this waits for the device). Ends the session."""
    global _session_over
    with _lock:
        _session_over = True
        records = list(_records)
    for rec in records:
        if rec.events is not None and rec.device_ms is None and \
                rec.end_ns is not None:
            rec.events[1].synchronize()
            rec.device_ms = rec.events[0].elapsed_time(rec.events[1])
    return records


def self_ns(records: list[Record], rec: Record) -> int:
    """`rec`'s host duration minus the part of it its child spans cover."""
    cover = sorted((max(c.start_ns, rec.start_ns), min(c.end_ns, rec.end_ns))
                   for c in records
                   if c.parent == rec.index and c.end_ns is not None)
    covered, reach = 0, rec.start_ns
    for s, e in cover:
        s = max(s, reach)
        if e > s:
            covered += e - s
            reach = e
    return rec.duration_ns - covered


def units(records: list[Record], top: str) -> list[Record]:
    """The finished units whose top span is named `top`."""
    return [r for r in records if r.name == top and r.parent is None
            and r.unit is not None and r.end_ns is not None
            and r.counts is not None]


def unit_mean_ms(top: str, name: str, own: bool = True) -> float | None:
    """Host milliseconds of the spans `name` a unit, mean over the units
    of `top`: their self time (`own`) or their whole duration. None where
    no such span ran in those units."""
    records = collect()
    tops = {r.unit for r in units(records, top)}
    found = [r for r in records if r.name == name and r.unit in tops
             and r.end_ns is not None]
    if not found:
        return None
    total = sum(self_ns(records, r) if own else r.duration_ns for r in found)
    return total * 1e-6 / len(tops)


def unit_mean_device_ms(top: str, name: str) -> float | None:
    """Device milliseconds between the CUDA events of the spans `name` a
    unit, mean over the units of `top`; None where none carried events."""
    records = collect()
    tops = {r.unit for r in units(records, top)}
    found = [r.device_ms for r in records if r.name == name
             and r.unit in tops and r.device_ms is not None]
    return sum(found) / len(tops) if found else None


def unit_mean_count(top: str, counter: str) -> float | None:
    """What `counter` counted a unit, mean over the units of `top`; None
    where there were none."""
    tops = units(collect(), top)
    if not tops:
        return None
    return sum(r.counts.get(counter, 0) for r in tops) / len(tops)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    """Counter `name`'s value (0 if never counted)."""
    return _counters.get(name, 0)


def set_counter(name: str, value: int = 0) -> None:
    """Set counter `name` (a reset, or a restore)."""
    with _lock:
        _counters[name] = value

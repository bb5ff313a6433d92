"""Spans and device marks at the port's layer boundaries.

Tracing is off by default; `enable()` turns it on for the process.

- `span(name)` wraps a layer's host work. With tracing on it keeps a
  `Span` in memory: its name, start and end on the host (`time.time_ns`,
  the clock of `torch.profiler`'s events), the enclosing span, and a call
  id that a span without a parent draws anew and its descendants share.
  Whenever a `torch.profiler` session is active, on or off, it also opens
  a profiler event of the same name, so the session places it on the
  timeline of the device's kernels. The event is an operator's
  (`RecordScope.FUNCTION`), not a user annotation: the profiler gives an
  annotation a device range over the kernels launched inside it, which
  would fill a reading of the device's busy time; an operator's event
  stays on the host. Off and with no profiler active, a span checks two
  flags and does nothing else.
- `mark(name, device)` is a device mark: with tracing on it records a
  timing event on the current stream (`torch.cuda.Event(enable_timing=True,
  external=True)`; the host's clock on the CPU, which runs its work in
  order) into the innermost set of marks open on this thread: the set a
  `marking(marks)` block names, else the innermost open span's own
  (`Span.marks`). A mark recorded while a CUDA graph is being captured
  becomes a node of the graph, and each replay sets its time again, so
  its owner keeps the set with the graph and reads it after a synchronise
  (`Marks.ms`: the last replay). Off, a mark records nothing, and graphs
  captured then are those of an untraced program.

The records stay in memory (`records()`, `clear()`); nothing is written
out. They grow with every span until `clear()`, each holding its marks
(on the eager route five CUDA events a step), so a caller that keeps
tracing on over a long run, an evaluation or a training run, calls
`clear()` after each read (`tools/profile_sampler.py --split` does so
after each call). A profiler session around a traced run (the trainer's
`profile_steps`, an operator's) sees the spans whether tracing is on or
not.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

_ProfilerEvent = torch._C._profiler._RecordFunctionFast


class Marks:
    """Device marks in the order they were recorded. `ms()` gives each gap
    between consecutive marks in milliseconds, under the later mark's name,
    summed by name; read it after the device has finished the marked work."""

    def __init__(self):
        self.names: List[str] = []
        self.points: list = []  # CUDA events, or host nanoseconds on the CPU

    def record(self, name: str, device: torch.device) -> None:
        if device.type == "cuda":
            point = torch.cuda.Event(enable_timing=True, external=True)
            point.record(torch.cuda.current_stream(device))
        else:
            point = time.perf_counter_ns()
        self.names.append(name)
        self.points.append(point)

    def ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, a, b in zip(self.names[1:], self.points, self.points[1:]):
            gap = (b - a) * 1e-6 if isinstance(a, int) else a.elapsed_time(b)
            out[name] = out.get(name, 0.0) + gap
        return out


class Span:
    """One span's record. `marks` holds the marks recorded inside it (no
    `marking` block between), `attached` sets of marks that their owner
    handed to it (`attach`): a graph's, whose replays the span enqueued."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call", "marks", "attached")

    def __init__(self, name: str, start_ns: int, parent: Optional["Span"], call: int):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.call = parent, call
        self.marks = Marks()
        self.attached: Dict[str, Marks] = {}

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


_on = False
_records: List[Span] = []
_calls = itertools.count(1)
_local = threading.local()  # this thread's open spans and sets of marks


def enable() -> None:
    """Tracing on for the process. Records accumulate until `clear()`."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def records() -> List[Span]:
    """The finished spans, in the order they ended."""
    return list(_records)


def clear() -> None:
    _records.clear()


def _stacks():
    if not hasattr(_local, "spans"):
        _local.spans, _local.sinks = [], []
    return _local.spans, _local.sinks


@contextlib.contextmanager
def span(name: str) -> Iterator[Optional[Span]]:
    """A span around the block; yields its record (None with tracing off)."""
    profiled = _profiler._is_profiler_enabled
    if not (_on or profiled):
        yield None
        return
    with contextlib.ExitStack() as stack:
        if profiled:
            stack.enter_context(_ProfilerEvent(name))
        if not _on:
            yield None
            return
        spans, sinks = _stacks()
        parent = spans[-1] if spans else None
        rec = Span(name, time.time_ns(), parent, parent.call if parent else next(_calls))
        spans.append(rec)
        sinks.append(rec.marks)
        try:
            yield rec
        finally:
            rec.end_ns = time.time_ns()
            spans.pop()
            sinks.pop()
            _records.append(rec)


def mark(name: str, device: torch.device) -> None:
    """A device mark on `device`'s current stream (see the module's docstring)."""
    if _on:
        sinks = _stacks()[1]
        if sinks:
            sinks[-1].record(name, device)


@contextlib.contextmanager
def marking(marks: Marks) -> Iterator[Marks]:
    """Marks recorded in the block go to `marks`."""
    sinks = _stacks()[1]
    sinks.append(marks)
    try:
        yield marks
    finally:
        sinks.pop()


def attach(label: str, marks: Marks) -> None:
    """Hand `marks` to the innermost open span, under `label` (tracing on)."""
    spans = _stacks()[0] if _on else None
    if spans:
        spans[-1].attached[label] = marks


_END = object()


def each(name: str, items: Iterable) -> Iterator:
    """`items`, each wait for the next item in a span `name`."""
    it = iter(items)
    while True:
        with span(name):
            item = next(it, _END)
        if item is _END:
            return
        yield item


def self_ms(rec: Span, spans: Iterable[Span], names: Optional[Iterable[str]] = None) -> float:
    """`rec`'s milliseconds outside its descendants among `spans` (those
    named in `names`, or all), each interval counted once."""
    names = None if names is None else set(names)
    inner = []
    for s in spans:
        if s is rec or (names is not None and s.name not in names):
            continue
        p = s.parent
        while p is not None and p is not rec:
            p = p.parent
        if p is rec:
            inner.append((s.start_ns, s.end_ns))
    covered, reach = 0, rec.start_ns
    for a, b in sorted(inner):
        a = max(a, reach)
        if b > a:
            covered += b - a
            reach = b
    return rec.ms - covered * 1e-6

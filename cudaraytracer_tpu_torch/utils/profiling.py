"""The port's one tracing module: named spans inside the program, on the
clock of the profiler's trace, and the trace's exporter.

``span(name, device=None, **attrs)`` marks a stretch of the program's own
work (``with profiling.span("render.chunk", rays=n): ...``).  Tracing is on
while a ``torch.profiler`` session is active in the process, or after
``enable()``.

* Off, a span is one check of that flag and a shared empty context: no
  ``record_function``, no clock read, nothing allocated.
* On, a span is a ``torch.profiler.record_function`` range, so the
  profiler's trace shows it beside the device operations, on their clock;
  and it appends a record to a bounded in-memory list: its name, id, the
  id of the span open around it (its parent), its start and end in ns of
  the Unix epoch (the clock of an exported trace:
  ``baseTimeNanoseconds + ts``), and its attributes.  With ``device`` a
  CUDA device it also records two timing events on the current stream,
  read as device ms only when the records are read (``records()``, after
  the caller's own synchronise): a span never waits for the device.

Spans nest in the order they open in the process: the autograd engine's
worker thread runs a CUDA backward while the caller waits in it, so the
spans of a checkpoint's recompute sit under the caller's span around the
backward.

Nothing is written out: ``records()`` and ``summary()`` read the list,
``trace(log_dir)`` exports a profiler trace of a block.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import _profiler_enabled

# the most records kept; the oldest go first
MAX_RECORDS = 1 << 16

_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_open: list = []
_ids = itertools.count(1)
_enabled = False
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "attrs",
                 "events", "_range")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self.attrs = name, attrs
        self.end_ns = None
        self.events = None
        if device is not None and torch.device(device).type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        self.id = next(_ids)
        self.parent = _open[-1].id if _open else None
        _open.append(self)
        _records.append(self)
        self.start_ns = time.time_ns()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self._range.__exit__(*exc)
        self.end_ns = time.time_ns()
        _open.pop()
        return False


def span(name: str, device=None, **attrs):
    """A context that records the block as the span ``name`` while tracing
    is on (module docstring); ``device``: time it on that CUDA device's
    current stream too; ``attrs``: numbers or strings kept with it."""
    if not (_enabled or _profiler_enabled()):
        return _OFF
    return _Span(name, device, attrs)


def enable() -> None:
    """Record spans with no profiler running."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler session is active."""
    global _enabled
    _enabled = False


def clear() -> None:
    """Drop every record."""
    _records.clear()


def _device_ms(r: _Span) -> Optional[float]:
    """The device ms between a span's events, or None: no events, or the
    end event not reached yet (the caller has not synchronised)."""
    if r.events is None or not r.events[1].query():
        return None
    return r.events[0].elapsed_time(r.events[1])


def records() -> List[dict]:
    """The ended spans, oldest first: name, id, parent (id or None),
    start_ns and end_ns (Unix epoch ns), attrs, device_ms (or None)."""
    return [{"name": r.name, "id": r.id, "parent": r.parent,
             "start_ns": r.start_ns, "end_ns": r.end_ns,
             "attrs": dict(r.attrs), "device_ms": _device_ms(r)}
            for r in list(_records) if r.end_ns is not None]


def summary() -> Dict[str, dict]:
    """{name: {count, host_ms, device_ms}} over the records: host ms
    summed, device ms summed over the spans that have it (None where none
    has)."""
    out: Dict[str, dict] = {}
    for r in records():
        row = out.setdefault(r["name"], {"count": 0, "host_ms": 0.0,
                                         "device_ms": None})
        row["count"] += 1
        row["host_ms"] += (r["end_ns"] - r["start_ns"]) * 1e-6
        if r["device_ms"] is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + r["device_ms"]
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA when a card
    is present), written to ``log_dir/trace.json`` (Chrome trace format:
    chrome://tracing or Perfetto).  Yields the profiler
    (``key_averages()`` for a table); spans inside the block record."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

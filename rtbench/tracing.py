"""Spans and the device trace.

``Spans``: named wall-clock spans, each ended after the caller's own sync
(the drivers end theirs where the program waits for the device), kept
in memory.  A span is also a ``torch.profiler.record_function`` range, so
that inside a traced window the trace says what the host was doing.

``DeviceTrace``: a ``torch.profiler`` run over a block, read back from its
Chrome trace: the device's operations (kernels, copies, sets) and the
host's ranges, in microseconds of one clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import stats

WINDOW = "rtbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            self.times[name].append(time.perf_counter() - t0)

    def snapshot(self) -> "Spans":
        out = Spans()
        out.times.update({k: list(v) for k, v in self.times.items()})
        return out

    def mean(self, name: str) -> Optional[float]:
        ts = self.times.get(name)
        return sum(ts) / len(ts) if ts else None


class Op(NamedTuple):
    name: str
    cat: str
    start: float    # microseconds
    end: float


class DeviceTrace(NamedTuple):
    device_ops: List[Op]     # the device's, inside the window
    host_ops: List[Op]       # the host's ranges (annotations and operators)
    window: tuple            # (start, end) of the traced window
    items: int               # items (frames, steps) completed inside it

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_s(self) -> float:
        return stats.union_seconds(((o.start, o.end) for o in self.device_ops),
                                   *self.window) * 1e-6

    def kernels(self) -> List[Op]:
        return [o for o in self.device_ops if o.cat == "kernel"]

    def kernel_seconds(self, pattern) -> float:
        return sum(o.end - o.start for o in self.kernels()
                   if pattern.search(o.name)) * 1e-6

    def breakdown(self, top: int = 10, labelled: int = 2000) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing at their start (its innermost
        annotation and operator there; the ``labelled`` longest gaps are
        labelled, the rest summed as one)."""
        by_op = defaultdict(float)
        for o in self.device_ops:
            by_op[o.name] += (o.end - o.start) * 1e-6
        hosts = [o for o in self.host_ops if o.name != WINDOW]
        starts = np.array([o.start for o in hosts])
        ends = np.array([o.end for o in hosts])
        is_annot = np.array([o.cat == "user_annotation" for o in hosts],
                            bool)
        span = ends - starts
        by_host = defaultdict(float)
        idle = sorted(stats.gaps([(o.start, o.end) for o in self.device_ops],
                                 *self.window), key=lambda g: g[0] - g[1])
        for s, e in idle[labelled:]:
            by_host["(shorter gaps)"] += (e - s) * 1e-6
        for s, e in idle[:labelled]:
            inner = (starts <= s) & (s < ends) if len(hosts) else None
            label = []
            for want in (True, False):
                if inner is None:
                    break
                k = np.flatnonzero(inner & (is_annot == want))
                if k.size:
                    label.append(hosts[int(k[np.argmin(span[k])])].name)
            by_host["/".join(label) or "(none)"] += (e - s) * 1e-6
        pick = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gap = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in pick],
                "idle_gaps": [[k, v] for k, v in gap]}


def _short(name: str) -> str:
    """A kernel's name without its template arguments' long tail."""
    return name if len(name) <= 160 else name[:157] + "..."


def traced(block, items_of) -> DeviceTrace:
    """Run ``block()`` under the profiler inside a ``WINDOW`` range and read
    the trace back; ``items_of(result)`` gives the items the block
    completed."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = block()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    window, device, host = None, [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        op = Op(_short(ev.get("name", "")), ev.get("cat", ""),
                float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        if op.cat in DEVICE_CATS:
            device.append(op)
        elif op.cat == "user_annotation" and op.name == WINDOW:
            window = (op.start, op.end)
        elif op.cat in ("user_annotation", "cpu_op"):
            host.append(op)
    if window is None:
        raise RuntimeError("the profiler's trace holds no window range")
    inside = [o for o in device if o.end > window[0] and o.start < window[1]]
    return DeviceTrace(inside, host, window, items_of(out))

"""Profiling and tracing (the JAX package's ``utils/profiling.py``), on
``torch.profiler``.

Two layers:
  * ``SectionTimer``: wall-clock spans, each ended after a sync of the
    device that holds the span's value, aggregated to count, total, mean,
    min and max;
  * ``trace``: a ``torch.profiler`` trace of a block (CPU, and CUDA when a
    card is present), exported as a Chrome trace; ``annotate`` names a span
    inside it (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch


def _sync(value) -> None:
    """Wait for the CUDA device of the first tensor found in ``value`` (a
    tensor, or a tuple, list or dict holding tensors)."""
    stack = [value]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(reversed(x))


class SectionTimer:
    """Named wall-clock spans.  ``section(name, sync_value)`` syncs the
    device of ``sync_value`` before the span ends (pass the tensors the
    block made); an error of that sync propagates (the JAX package's
    timer swallowed it, profiling.py:32-42)."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        yield
        if sync_value is not None:
            _sync(sync_value)
        self.spans[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"count": len(ts), "total": sum(ts),
                       "mean": sum(ts) / len(ts), "min": min(ts),
                       "max": max(ts)}
                for name, ts in self.spans.items()}

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total"]):
            lines.append(f"{name:30s} n={s['count']:4d} "
                         f"total={s['total']:8.3f}s "
                         f"mean={s['mean'] * 1e3:8.2f}ms")
        return "\n".join(lines)

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block, written to
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto).  Yields the profiler (``key_averages()`` for a table)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span of host and device work inside a ``trace``."""
    return torch.profiler.record_function(name)

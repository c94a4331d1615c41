"""The share of the traced window (fit) in which no device operation
runs: 100 x (1 - the union of the profiler's kernel, copy and set
intervals over the window)."""

from rtbench.metrics import _read


def read(ctx):
    return _read.idle_share(ctx)

"""Device kernels per item (frame), counted from the profiler's CUDA
kernel events in the traced units."""

from rtbench.metrics import _read


def read(ctx):
    return _read.launches_per_item(ctx)

"""What the per-layer readers share.  A reader returns None where it finds
nothing to read, and the harness then leaves its metric out."""

from __future__ import annotations

import re

from rtbench import stats

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
# the 700 W power limit): FP32 outside the tensor cores, HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def span_ms(ctx, name: str):
    m = ctx.spans.mean(name)
    return None if m is None else m * 1e3


def launches_per_item(ctx):
    t = ctx.trace
    n = len(t.kernels())
    return n / t.items if n and t.items else None


def idle_share(ctx):
    t = ctx.trace
    busy = t.busy_s()
    if busy <= 0.0 or t.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - busy / t.window_s)


def roofline(ctx):
    """100 x the frozen bound of an item's work in the kernels that match
    the data file's pattern over their device time per item."""
    d, t = ctx.data, ctx.trace
    if not t.items or not d or "flops_per_item" not in d:
        return None
    kernel_s = t.kernel_seconds(re.compile(d["kernel_pattern"])) / t.items
    bound_s, _ = stats.bound_seconds(d["flops_per_item"],
                                     d["bytes_per_item"], PEAK_FP32,
                                     PEAK_BYTES)
    return stats.roofline_share(bound_s, kernel_s)

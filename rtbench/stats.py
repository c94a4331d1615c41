"""The arithmetic of the metrics: rates over a window, percentiles over
items, the union of device intervals, roofline shares."""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple


def per_item(window_s: float, items: int) -> float:
    """Window seconds over the items completed in it."""
    if items <= 0:
        raise ValueError("no item completed in the window")
    return window_s / items


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between the two
    nearest ranks (numpy's default)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_seconds(intervals: Iterable[Tuple[float, float]],
                  lo: Optional[float] = None,
                  hi: Optional[float] = None) -> float:
    """The length of the union of [start, end) intervals, clipped to [lo,
    hi] when given (same unit as the intervals)."""
    spans = []
    for s, e in intervals:
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e > s:
            spans.append((s, e))
    spans.sort()
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if e <= cur:
            continue
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def roofline_share(bound_s: float, kernel_s: float) -> Optional[float]:
    """100 x the least time the work could take over the time it took, or
    None where no kernel time was read."""
    if kernel_s <= 0.0:
        return None
    return 100.0 * bound_s / kernel_s


def bound_seconds(flops: float, bytes_: float, peak_flops: float,
                  peak_bytes: float) -> Tuple[float, str]:
    """(seconds, 'operations' or 'bytes'): the larger of the operations
    over the FP32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak_flops, bytes_ / peak_bytes
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


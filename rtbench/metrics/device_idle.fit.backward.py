"""The share of the traced window (fit) in which the device idles while
the host is inside the backward: 100 x the idle gaps (no kernel, copy or
set running) that start inside a ``fit.backward`` span
(``parallel/train.value_and_grad``), over the window."""

from rtbench import stats
from rtbench.metrics import _spans


def read(ctx):
    t = ctx.trace
    inside = _spans.ranges(ctx, "fit.backward")
    if not inside or t.window_s <= 0.0:
        return None
    idle = stats.gaps([(o.start, o.end) for o in t.device_ops], *t.window)
    us = sum(e - s for s, e in idle
             if any(r.start <= s < r.end for r in inside))
    return 100.0 * us * 1e-6 / t.window_s

"""What the readers of the program's own spans share
(``cudaraytracer_tpu_torch/utils/profiling.py``): a span's host ranges in
the traced units' trace, and the program's records of it, which carry
its device ms.  The spans record only while the profiler runs, so the
records are the traced units'.  A program without a span (a checkout from
before it) leaves no range and no record, and its readers return None."""

from __future__ import annotations


def ranges(ctx, name: str) -> list:
    """The host ranges (``tracing.Op``) of the span ``name`` in the trace."""
    return [o for o in ctx.trace.host_ops
            if o.cat == "user_annotation" and o.name == name]


def range_ms(ctx, name: str) -> list:
    """The host ms of each range of the span ``name`` in the trace."""
    return [(o.end - o.start) * 1e-3 for o in ranges(ctx, name)]


def recorded(ctx, name: str):
    """The program's records of the span ``name`` for the ranges the trace
    holds (the newest as many), or None: no range, or a program that keeps
    no records."""
    n = len(ranges(ctx, name))
    if not n:
        return None
    from cudaraytracer_tpu_torch.utils import profiling
    read = getattr(profiling, "records", None)
    if read is None:
        return None
    recs = [r for r in read() if r["name"] == name]
    return recs[-n:] if len(recs) >= n else None


def device_ms(ctx, name: str):
    """The device ms summed over the records of the span ``name`` in the
    traced units, or None where a record has none."""
    recs = recorded(ctx, name)
    if not recs or any(r["device_ms"] is None for r in recs):
        return None
    return sum(r["device_ms"] for r in recs)

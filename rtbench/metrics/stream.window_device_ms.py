"""The device ms a traced frame spends in the fused path's launches: the
program's ``mega.window`` spans (``ops/megakernel._trace``, CUDA-timed:
each bounce window of the compaction drivers, or a monolithic launch as
one window of every step) summed over the traced frames, over the
frames."""

from rtbench.metrics import _spans


def read(ctx):
    ms = _spans.device_ms(ctx, "mega.window")
    if ms is None or not ctx.trace.items:
        return None
    return ms / ctx.trace.items

"""The device ms a traced frame spends regrouping the wavefront between
bounce windows: the program's ``mega.regroup`` spans
(``ops/megakernel._next_order``, CUDA-timed, one a sort of the keys)
summed over the traced frames, over the frames.  0.0 where the frames
open ``mega.window`` spans and no regroup (a monolithic route); None
where they open neither (a program without the spans)."""

from rtbench.metrics import _spans


def read(ctx):
    if not ctx.trace.items or not _spans.ranges(ctx, "mega.window"):
        return None
    if not _spans.ranges(ctx, "mega.regroup"):
        return 0.0
    ms = _spans.device_ms(ctx, "mega.regroup")
    return None if ms is None else ms / ctx.trace.items

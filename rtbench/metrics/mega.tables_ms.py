"""The host ms a traced frame spends building the fused engine's tables:
the program's ``mega.tables`` spans (``ops/megakernel.build_mega_tables``)
summed over the traced frames, over the frames."""

from rtbench.metrics import _spans


def read(ctx):
    ms = _spans.range_ms(ctx, "mega.tables")
    if not ms or not ctx.trace.items:
        return None
    return sum(ms) / ctx.trace.items

"""The mean host ms of a render chunk: the program's ``render.chunk``
spans (one pass of ``ops/render.render_pixels``' chunk loop: its camera
rays and its integrator's launches) in the traced frames."""

from rtbench.metrics import _spans


def read(ctx):
    ms = _spans.range_ms(ctx, "render.chunk")
    return sum(ms) / len(ms) if ms else None

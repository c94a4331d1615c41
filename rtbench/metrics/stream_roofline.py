"""The streamed route's share of its roofline: the frozen bound of a
frame's work (stream_roofline.json: FLOPs and bytes of the fused launches
of a frame of big_field.path8, counted once on the card by
count_stream.py on three routes, the lowest kept) over the device time
per frame of the fused kernels its name pattern matches (K6, K10, K11 on
any route)."""

from rtbench.metrics import _read


def read(ctx):
    return _read.roofline(ctx)

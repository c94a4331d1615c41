"""The kernel's share of its roofline: the frozen bound of an item's work
(k1_roofline.json: FLOPs and bytes an item, counted once on the card)
over the device time per item of the kernels its name pattern matches."""

from rtbench.metrics import _read


def read(ctx):
    return _read.roofline(ctx)

"""The fit step's backward over its forward in device time: the device ms
between the CUDA events of the program's ``fit.backward`` spans over those
of its ``fit.forward`` spans (``parallel/train.value_and_grad``), in the
traced steps themselves: no split step, no sync of its own."""

from rtbench.metrics import _spans


def read(ctx):
    fwd = _spans.device_ms(ctx, "fit.forward")
    bwd = _spans.device_ms(ctx, "fit.backward")
    if not fwd or bwd is None:
        return None
    return bwd / fwd

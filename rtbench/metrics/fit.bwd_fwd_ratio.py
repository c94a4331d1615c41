"""The fit step's backward over its forward: synced spans around
parallel/train.pixel_loss and torch.autograd.grad on the step's own
inputs (the fit driver's split steps after the window)."""


def read(ctx):
    fwd, bwd = ctx.spans.mean("forward"), ctx.spans.mean("backward")
    if not fwd or bwd is None:
        return None
    return bwd / fwd

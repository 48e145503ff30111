"""Device kernels a training step in the traced window (those a replayed
CUDA graph runs included), over the window's steps."""
UNIT = "kernels/step"


def read(ctx):
    if not ctx.steps or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.steps

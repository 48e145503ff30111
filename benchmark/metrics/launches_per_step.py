"""Host launches a training step in the traced window: kernel launches,
CUDA-graph replays, copies and memsets through the CUDA runtime and
driver (the epoch driver's staging, the replay, the per-step metric
copies), over the window's steps."""
UNIT = "launches/step"


def read(ctx):
    return len(ctx.trace.launches) / ctx.steps if ctx.steps else None

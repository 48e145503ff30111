"""The epoch driver's host time a step: the traced window's
``driver.step`` spans (the online reseed, the staging, the replay or eager
step, the copy of the step's metrics), over the window's steps, in
microseconds."""
from benchmark import spans

UNIT = "us/step"


def read(ctx):
    seconds = spans.total_seconds(ctx.trace, "driver.step")
    if seconds is None or not ctx.steps:
        return None
    return 1e6 * seconds / ctx.steps

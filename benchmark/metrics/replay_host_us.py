"""The host time of a step's graph replay: the traced window's
``driver.replay`` spans (``graph.replay()`` and its counts), over the
window's steps, in microseconds."""
from benchmark import spans

UNIT = "us/step"


def read(ctx):
    seconds = spans.total_seconds(ctx.trace, "driver.replay")
    if seconds is None or not ctx.steps:
        return None
    return 1e6 * seconds / ctx.steps

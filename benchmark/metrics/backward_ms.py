"""The backward phase of a replayed training step on the device: from the
loss to the gradients (a mesh's mean included), in milliseconds. The
mean of the program's readings in the traced window, one an epoch: the
phases of the epoch's last replay, from timing events that the step's
capture recorded into its graph."""
from benchmark import spans

UNIT = "ms/step"


def read(ctx):
    return spans.phase_ms("backward")

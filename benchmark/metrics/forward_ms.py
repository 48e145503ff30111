"""The forward phase of a replayed training step on the device: from the
step's start to its loss (the batch's gather and decode, or the online
draws' transform and render, then the forward), in milliseconds. The
mean of the program's readings in the traced window, one an epoch: the
phases of the epoch's last replay, from timing events that the step's
capture recorded into its graph. A replay launched onto an idle device
counts the launch's latency before its first kernel here (about 0.1 ms
on an H100), so in a host-paced cell this reads above the forward's
kernels."""
from benchmark import spans

UNIT = "ms/step"


def read(ctx):
    return spans.phase_ms("forward")

"""The whole step's share of the card's peak, in percent: the operations
the step's products need (the configuration's count from its shapes:
forward, the weights' gradients and the inputs' where needed; frozen
parts forward only; nothing recomputed counted) times the steps of the
traced window, over the window's seconds and the peak of the traffic's
precision."""
UNIT = "%"


def read(ctx):
    peak = ctx.peak_flops
    if peak is None or not ctx.steps:
        return None
    return 100.0 * ctx.products["flops"] * ctx.steps \
        / ctx.trace.window_s / peak

"""The share of the traced window in which the device ran nothing: one
minus the union of its kernels', copies' and memsets' intervals over the
window, in percent."""
UNIT = "%"


def read(ctx):
    if not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)

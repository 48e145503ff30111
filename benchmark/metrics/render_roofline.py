"""The render kernel's share of its roofline, in percent: each launch's
least time is its bytes over the memory's rate (the batch's images
written once as float32, its factors read once), times the launches in
the traced window, over their device time."""
UNIT = "%"
KERNEL = "render_kernel"


def read(ctx):
    launches = [e for e in ctx.trace.kernels if KERNEL in e["name"]]
    if not launches or ctx.peak_bytes is None:
        return None
    cfg = ctx.cell.config
    b, s = cfg["batch_size"], cfg["image_size"]
    bytes_ = 4 * (b * s * s * 3 + b * 4)
    seconds = sum(e["dur"] for e in launches) / 1e6
    return 100.0 * len(launches) * bytes_ / ctx.peak_bytes / seconds

"""The epoch's end on the host: the traced window's ``driver.epoch_end``
spans (the metrics' reduction and the epoch's one host sync), over the
window's epochs (the traffic's ``trace_epochs``), in milliseconds."""
from benchmark import spans

UNIT = "ms/epoch"


def read(ctx):
    seconds = spans.total_seconds(ctx.trace, "driver.epoch_end")
    epochs = ctx.cell.traffic["trace_epochs"]
    if seconds is None or not epochs:
        return None
    return 1e3 * seconds / epochs

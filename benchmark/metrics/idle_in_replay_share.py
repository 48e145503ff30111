"""The device's idle share while the host is inside its ``driver.replay``
spans: the traced window's device-idle time inside those spans over the
spans' own time, in percent. Beside ``device_idle_share`` (the whole
window's), it says whether the device idles more while the host launches
its graph than elsewhere: a share above the window's puts the idle time
in the launch, one at or below it does not."""
from benchmark import spans, tracing

UNIT = "%"


def read(ctx):
    t = ctx.trace
    replays = spans.merged(spans.intervals(t, "driver.replay"))
    inside = sum(e - s for s, e in replays)
    if inside <= 0 or not t.device:
        return None
    device = [(max(e["ts"], t.lo), min(e["ts"] + e["dur"], t.hi))
              for e in t.device]
    idle = sorted(tracing.gaps(device, t.lo, t.hi))
    return 100.0 * spans.overlap(idle, replays) / inside

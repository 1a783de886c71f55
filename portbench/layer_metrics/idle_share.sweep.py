"""Share of the traced window in which no operation ran on the card: one
minus the union of the device intervals over the window."""
from portbench import yardstick


def read(ctx):
    if not ctx.trace.intervals:
        return None
    busy = yardstick.busy_seconds(ctx.trace.intervals)
    return 100.0 * (1.0 - busy / ctx.window_s)

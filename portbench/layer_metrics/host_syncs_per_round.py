"""Device-to-host reads per round of the device engine's Python loop:
``DeviceStats.host_syncs`` over ``rounds_run``, summed over the window's
rollouts.  Every sync stalls the host until the card drains."""


def read(ctx):
    w = ctx.window
    return w.host_syncs / w.rounds_run if w.rounds_run else None

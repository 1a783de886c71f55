"""Device operations (kernels, copies, fills) the traced window ran, over
the rounds its rollouts ran: what one round costs the host to issue."""


def read(ctx):
    n = ctx.trace.n_ops
    return n / ctx.window.rounds_run if n and ctx.window.rounds_run else None

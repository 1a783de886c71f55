"""B5, the masked attention forward (``kernels/flash_attention``'s
``mha_fwd_kernel``), against its roofline on this data: per launch (one
encoder layer of one forward) q read once, k and v only within each
row's length (its queue plus the context token), o and lse written once,
two FMAs of the head width per (query, kept key); the mean over the
probe's forwards, times the launches the trace holds, over their summed
time."""
import numpy as np

from portbench import yardstick


def read(ctx):
    t = ctx.trace.seconds(yardstick.B5)
    n = ctx.trace.count(yardstick.B5)
    if t <= 0 or n == 0 or not ctx.qlens:
        return None
    a = ctx.config["agent"]
    H, S = a["attn_heads"], a["queue_cap"] + 1
    dh = a["attn_dim"] // H
    bh = ctx.layout.n_envs * H
    per_launch = np.mean([
        yardstick.bound_s(*yardstick.mha_cost(
            H * int(np.ceil(np.clip(q + 1.0, 0, S)).sum()), bh, S, dh))
        for q in ctx.qlens])
    return 100.0 * float(per_launch) * n / t

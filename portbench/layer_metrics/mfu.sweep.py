"""The whole forward's share of the card's float32 peak: model FLOPs of
one row per decision (``yardstick.decision_flops``; the encoder at the
tokens each decision's queue holds, up to Q, averaged over the probe's
decisions), times the traced window's decisions, over the window and
the peak.  It bounds every kernel's share: work done for rows that
decide nothing is not counted."""
import numpy as np

from portbench import yardstick


def read(ctx):
    if not ctx.window.decisions:
        return None
    if ctx.qlens is not None:
        q = np.concatenate([ql[d] for ql, d in zip(ctx.qlens, ctx.deciding)])
        per_decision = float(np.mean(yardstick.decision_flops(ctx.config, q)))
    else:
        per_decision = yardstick.decision_flops(ctx.config)
    flops = per_decision * ctx.window.decisions
    return 100.0 * flops / (ctx.window_s * yardstick.PEAK_F32_FLOP_PER_S)

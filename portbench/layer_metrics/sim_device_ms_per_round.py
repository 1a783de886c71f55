"""Device time a round spends on the simulation, not the policy: the
operations launched in a ``round`` span outside its ``forward`` (by their
launch records), over the rounds run."""
from portbench import phases


def read(ctx):
    spans = getattr(ctx, "spans", None) or ()
    ops = getattr(ctx, "op_phase", None)
    n = phases.rounds(spans)
    if not n or ops is None:
        return None
    sim = set(phases.ROUND) - {"forward"} | {"round"}
    return sum(e - s for (s, e, _), p in zip(ctx.trace.intervals, ops)
               if p in sim) / 1e6 / n

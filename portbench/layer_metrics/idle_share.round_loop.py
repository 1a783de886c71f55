"""Share of the traced window in which the card is idle while the host is
in the round loop's own phases (``advance``, ``sync.*``, ``select``,
``backfill``, ``record``), not issuing the front or the forward."""
from portbench import phases


def read(ctx):
    spans = getattr(ctx, "spans", None) or ()
    if not phases.rounds(spans) or not ctx.window_s:
        return None
    idle = phases.idle_by_span(spans, ctx.trace.intervals)
    ns = sum(i for s, i in zip(spans, idle) if s.name in phases.LOOP)
    return 100.0 * ns / 1e9 / ctx.window_s

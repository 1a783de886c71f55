"""Device time of one policy forward in the device round loop: the
operations launched in the program's ``forward`` spans (by their launch
records), over those spans."""


def read(ctx):
    spans = getattr(ctx, "spans", None) or ()
    ops = getattr(ctx, "op_phase", None)
    n = sum(s.name == "forward" for s in spans)
    if not n or ops is None:
        return None
    return sum(e - s for (s, e, _), p in zip(ctx.trace.intervals, ops)
               if p == "forward") / 1e6 / n

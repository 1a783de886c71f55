"""Host time a round of the device round loop spends issuing work, not
waiting on the card: the program's ``round`` spans less their ``sync.*``
spans, over the rounds run."""
from portbench import phases


def read(ctx):
    spans = getattr(ctx, "spans", None) or ()
    n = phases.rounds(spans)
    if not n:
        return None
    ns = sum((s.end_ns - s.start_ns) * (1 if s.name == "round" else -1)
             for s in spans if s.name == "round" or s.name in phases.SYNC)
    return ns / 1e6 / n

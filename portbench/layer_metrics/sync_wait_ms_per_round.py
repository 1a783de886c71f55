"""Host time a round of the device round loop spends blocked in its
device-to-host reads: the program's ``sync.gate`` and ``sync.backfill``
spans, over the rounds run."""
from portbench import phases


def read(ctx):
    spans = getattr(ctx, "spans", None) or ()
    n = phases.rounds(spans)
    if not n:
        return None
    return sum(s.end_ns - s.start_ns for s in spans
               if s.name in phases.SYNC) / 1e6 / n

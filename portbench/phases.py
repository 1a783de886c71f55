"""The device round loop's phases: the program's spans read against the
profiler's records of the same window.  Of the program this reads only
``repro_torch.obs.profiling.span_summary``, the spans' self times.

The program records its spans (``repro_torch.obs.SpanRecorder``, passed
to ``DeviceSimulator`` and to ``rollout``) as (name, start ns, end ns,
parent, rollout, round) on the clock Kineto reports its records on.
A device operation belongs to the span in which the host launched it:
its correlation id leads to the CUDA runtime's (or driver's) launch
record, and the launch's start lies in the innermost span that holds it.
An idle stretch of the card belongs to the innermost span the host was
in while it lasted, split where the host moved on.  A span's own
("self") time is its length less its children's.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from portbench import yardstick

SYNC = ("sync.gate", "sync.backfill")
# A round's phases, in order; sync.backfill lies inside backfill.
ROUND = ("advance", "sync.gate", "front", "forward", "select", "backfill",
         "sync.backfill", "record")
# Phases in which the host launches none of the round's large work (the
# front and the forward): the card's idle time there is the loop's own.
LOOP = ("advance", *SYNC, "select", "backfill", "record")
# Host records of a capture are the CUDA runtime's and driver's calls
# (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cuLaunchKernel``, ...),
# the program's ranges and Kineto's own ("Buffer Flush", ...), some of
# which share a launch's correlation id: a launch record is a host
# record named ``cu*``.
LAUNCH_PREFIX = "cu"


@dataclass
class Profile:
    """One pass over the profiler's records: the device trace exactly as
    ``yardstick.device_events`` reads it, the correlation id of each of
    its intervals (in their order), and the start of each launch record
    by correlation id."""
    trace: yardstick.DeviceTrace
    correlation: List[int]
    launches: Dict[int, int]


def read_profile(prof) -> Profile:
    from torch.autograd import DeviceType
    ops: Dict[str, yardstick.DeviceOp] = {}
    rows = []
    launches: Dict[int, int] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            if e.name().startswith(LAUNCH_PREFIX):
                launches.setdefault(e.correlation_id(), e.start_ns())
            continue
        if (e.is_user_annotation()
                or getattr(e, "is_hidden_event", lambda: False)()
                or e.name().startswith("[")):
            continue
        op = ops.setdefault(e.name(), yardstick.DeviceOp(e.name()))
        op.count += 1
        op.seconds += e.duration_ns() / 1e9
        t0 = e.start_ns()
        rows.append((t0, t0 + e.duration_ns(), e.name(), e.correlation_id()))
    rows.sort()
    return Profile(yardstick.DeviceTrace(ops, [r[:3] for r in rows]),
                   [r[3] for r in rows], launches)


# ------------------------------------------------------------ the tree
def self_segments(spans: Sequence) -> List[Tuple[int, int, int]]:
    """(start, end, span index) of every stretch in which a span is the
    innermost one open, sorted by start; the stretches do not overlap."""
    children: List[List[int]] = [[] for _ in spans]
    for i, s in enumerate(spans):
        if s.parent >= 0:
            children[s.parent].append(i)
    segs = []
    for i, s in enumerate(spans):
        cursor = s.start_ns
        for c in children[i]:
            if spans[c].start_ns > cursor:
                segs.append((cursor, spans[c].start_ns, i))
            cursor = max(cursor, spans[c].end_ns)
        if s.end_ns > cursor:
            segs.append((cursor, s.end_ns, i))
    segs.sort()
    return segs


def op_spans(spans: Sequence, prof: Profile) -> List[int]:
    """Per interval of ``prof.trace``: the index of the innermost span
    that holds its launch record's start, or -1 (no launch record, or a
    launch outside every span)."""
    segs = self_segments(spans)
    starts = [a for a, _, _ in segs]
    out: List[int] = []
    for corr in prof.correlation:
        t = prof.launches.get(corr)
        k = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        out.append(segs[k][2] if k >= 0 and t < segs[k][1] else -1)
    return out


def clock_gaps(spans: Sequence, prof: Profile, at: Sequence[int],
               name: str):
    """Per span called ``name`` that holds a launch (``at``: ``op_spans``
    of ``prof``): (its first launch's
    start less the span's start, the span's end less the end of the last
    device operation launched in it), in ns.  Around a read that waits
    for the card both are small and positive when the spans and the
    profiler's records share one clock."""
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    for (_, e, _), corr, i in zip(prof.trace.intervals, prof.correlation,
                                  at):
        if i >= 0 and spans[i].name == name:
            t = prof.launches[corr]
            first[i] = min(first.get(i, t), t)
            last[i] = max(last.get(i, e), e)
    return [(first[i] - spans[i].start_ns, spans[i].end_ns - last[i])
            for i in sorted(first)]


def merged(intervals: Iterable[Tuple[int, int, str]]) -> List[Tuple[int, int]]:
    """The union of sorted device intervals, as disjoint (start, end)."""
    out: List[List[int]] = []
    for s, e, _ in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_by_span(spans: Sequence, intervals) -> List[int]:
    """Per span: the ns of its own time in which no device operation
    ran."""
    busy = merged(intervals)
    idle = [0] * len(spans)
    j = 0
    for a, b, i in self_segments(spans):
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        covered, k = 0, j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
        idle[i] += (b - a) - covered
    return idle


# ------------------------------------------------------------ the table
@dataclass
class PhaseRow:
    spans: int = 0
    host_self_ns: int = 0
    device_ns: int = 0
    ops: int = 0
    idle_ns: int = 0


def phase_table(spans: Sequence, intervals, phases: Sequence[Optional[str]]
                ) -> Dict[Optional[str], PhaseRow]:
    """Per span name: spans, host self time, device time and operations
    launched there, and the card's idle time while the host was there;
    the key None holds the operations put down to no span."""
    # Imported here, not at the top: the metric readers import this module
    # and must load (and read nothing) on a program older than the spans.
    from repro_torch.obs.profiling import span_summary
    rows: Dict[Optional[str], PhaseRow] = {
        name: PhaseRow(n, own)
        for name, (n, _, own) in span_summary(spans).items()}
    for s, idle in zip(spans, idle_by_span(spans, intervals)):
        rows[s.name].idle_ns += idle
    for (s, e, _), name in zip(intervals, phases):
        r = rows.setdefault(name, PhaseRow())
        r.ops += 1
        r.device_ns += e - s
    return rows


def rounds(spans: Sequence) -> int:
    return sum(s.name == "round" for s in spans)


def round_cover(spans: Sequence) -> float:
    """The largest share of a round that its children leave uncovered."""
    kids: Dict[int, int] = {}
    for s in spans:
        if s.parent >= 0 and spans[s.parent].name == "round":
            kids[s.parent] = kids.get(s.parent, 0) + s.end_ns - s.start_ns
    worst = 0.0
    for i, s in enumerate(spans):
        if s.name == "round" and s.end_ns > s.start_ns:
            worst = max(worst, abs(1.0 - kids.get(i, 0)
                                   / (s.end_ns - s.start_ns)))
    return worst


def table_lines(rows: Dict[Optional[str], PhaseRow]) -> List[str]:
    order = ["setup.pack", "rollout", "round", *ROUND, "outputs"]
    names = [n for n in order if n in rows]
    names += sorted(n for n in rows if n not in order and n is not None)
    if None in rows:
        names.append(None)
    out = []
    for n in names:
        r = rows[n]
        out.append(f"phase {n or '(no span)'}: {r.spans} spans, host self "
                   f"{r.host_self_ns / 1e6:.3f} ms, device "
                   f"{r.device_ns / 1e6:.3f} ms, {r.ops} ops, idle "
                   f"{r.idle_ns / 1e6:.3f} ms")
    return out

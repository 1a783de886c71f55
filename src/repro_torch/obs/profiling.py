"""Profiling hooks: named profiler ranges, wall-clock spans, and the span
recorder of the device round loop.

- :func:`annotate` and :func:`named_scope` open a
  ``torch.profiler.record_function(name)`` range while a profiler runs: a
  range on the host timeline of a ``torch.profiler`` capture, to which the
  kernels launched inside it are attributed.  With no profiler enabled
  they return one shared no-op context, which costs one flag read (a
  ``record_function`` range costs ~8-15 us to enter and exit even when
  nothing records it).  ``named_scope`` wraps every kernel dispatch
  (``mrsch.kernel.*``), ``annotate`` the engine and trainer phases
  (``mrsch.device.rollout``, ``mrsch.vector.policy_select``,
  ``mrsch.train.*``).  This package has no trace-time name stack, so the
  two are one mechanism under the JAX package's two names.
- :func:`span` is the tracer-facing counterpart: it measures a wall-clock
  phase and emits a ``prof.span`` event, which ``tools/trace_report.py``
  aggregates into the per-phase time table.
- :class:`SpanRecorder` keeps nested spans in memory, on the profiler's
  clock, for code that passes it in (``DeviceSimulator(spans=)``,
  ``DeviceSimulator.rollout(spans=)``).  It opens no profiler range, so a
  span costs two clock reads whether or not a profiler runs, and its
  spans line up with the launch and device records of a capture taken at
  the same time.
"""
from __future__ import annotations

import contextlib
import time
from typing import (ContextManager, Dict, List, NamedTuple, Sequence,
                    Tuple)

import torch

from .trace import NULL, Tracer

__all__ = ["annotate", "named_scope", "span", "Span", "SpanRecorder",
           "span_summary"]

# What annotate and named_scope return while no profiler is enabled.
NO_RANGE = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def annotate(name: str) -> ContextManager:
    """Host-side profiler range ``name`` around an engine phase."""
    return torch.profiler.record_function(name) if _profiling() else NO_RANGE


def named_scope(name: str) -> ContextManager:
    """Profiler range ``name`` around a kernel dispatch."""
    return torch.profiler.record_function(name) if _profiling() else NO_RANGE


@contextlib.contextmanager
def span(tracer: Tracer, name: str):
    """Time a wall-clock phase; emit ``prof.span`` + a profiler range
    ``mrsch.<name>``.  Safe (and free of events) with the NULL tracer."""
    with annotate(f"mrsch.{name}"):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            (tracer or NULL).span(name, time.perf_counter() - t0)


class Span(NamedTuple):
    """One recorded span.  ``start_ns``/``end_ns`` are on the profiler's
    clock (Unix nanoseconds, as Kineto reports its records); ``parent`` is
    the index of the enclosing span in :meth:`SpanRecorder.spans`, -1 for
    none; ``rollout`` and ``round`` are -1 outside a rollout or a round."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    rollout: int
    round: int


class SpanRecorder:
    """Nested spans kept in memory until read.

    ``open`` starts spans inside the innermost open one, ``close`` ends the
    innermost ones, ``next`` ends the innermost and starts its next
    sibling at the same instant, so consecutive phases cover their parent
    without gaps.  Times are ``time.perf_counter_ns()`` moved onto the
    Unix clock by a pair of readings taken when the recorder is made and
    again at each :meth:`start_rollout`.  ``counts`` counts the spans
    opened by name: the phase counters.  Callers set ``round`` to the
    round index the spans they open belong to.
    """

    def __init__(self) -> None:
        # One list per field: appending ints and strings allocates nothing
        # the garbage collector has to walk, however many spans pile up.
        self._name: List[str] = []
        self._start: List[int] = []
        self._end: List[int] = []
        self._parent: List[int] = []
        self._rollout: List[int] = []
        self._round: List[int] = []
        self._open: List[int] = []
        self.counts: Dict[str, int] = {}
        self.rollout = -1
        self.round = -1
        self._sync_clock()

    def _sync_clock(self) -> None:
        self._offset = time.time_ns() - time.perf_counter_ns()

    def start_rollout(self) -> int:
        """Begin the next rollout's spans: a new rollout id, no round, no
        span left open by one that raised, and a fresh clock pair."""
        self.rollout += 1
        self.round = -1
        self._open.clear()
        self._sync_clock()
        return self.rollout

    def _push(self, name: str, t: int) -> None:
        self._parent.append(self._open[-1] if self._open else -1)
        self._open.append(len(self._name))
        self._name.append(name)
        self._start.append(t)
        self._end.append(t)
        self._rollout.append(self.rollout)
        self._round.append(self.round)
        self.counts[name] = self.counts.get(name, 0) + 1

    def open(self, *names: str) -> None:
        """Start ``names``, each inside the one before, at one instant."""
        t = time.perf_counter_ns() + self._offset
        for name in names:
            self._push(name, t)

    def close(self, n: int = 1) -> None:
        """End the ``n`` innermost open spans at one instant."""
        t = time.perf_counter_ns() + self._offset
        for _ in range(n):
            self._end[self._open.pop()] = t

    def next(self, name: str) -> None:
        """End the innermost open span and start ``name`` in its place."""
        t = time.perf_counter_ns() + self._offset
        self._end[self._open.pop()] = t
        self._push(name, t)

    def spans(self) -> List[Span]:
        """Every span, in the order opened (a span still open ends where
        it starts); ``parent`` indexes this list."""
        return [Span(*r) for r in zip(self._name, self._start, self._end,
                                      self._parent, self._rollout,
                                      self._round)]


def span_summary(spans: Sequence) -> Dict[str, Tuple[int, int, int]]:
    """Per span name: (count, total ns, self ns), where a span's self time
    is its own less that of its children.  ``spans`` is
    :meth:`SpanRecorder.spans` or anything with its fields."""
    child_ns = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            child_ns[s.parent] += s.end_ns - s.start_ns
    out: Dict[str, Tuple[int, int, int]] = {}
    for s, kids in zip(spans, child_ns):
        n, tot, own = out.get(s.name, (0, 0, 0))
        dur = s.end_ns - s.start_ns
        out[s.name] = (n + 1, tot + dur, own + dur - kids)
    return out

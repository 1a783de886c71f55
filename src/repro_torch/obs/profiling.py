"""Profiling hooks: named profiler ranges + wall-clock spans.

- :func:`annotate` and :func:`named_scope` — both
  ``torch.profiler.record_function(name)``: a range on the host timeline
  of a ``torch.profiler`` capture, to which the kernels launched inside
  it are attributed.  It costs a few microseconds when no profiler runs.
  ``named_scope`` wraps every kernel dispatch (``mrsch.kernel.*``),
  ``annotate`` the engine and trainer phases (``mrsch.device.rollout``,
  ``mrsch.vector.policy_select``, ``mrsch.train.*``).  This package has
  no trace-time name stack, so the two are one mechanism under the JAX
  package's two names.
- :func:`span` is the tracer-facing counterpart: it measures a wall-clock
  phase and emits a ``prof.span`` event, which ``tools/trace_report.py``
  aggregates into the per-phase time table.
"""
from __future__ import annotations

import contextlib
import time
from typing import ContextManager

import torch

from .trace import NULL, Tracer

__all__ = ["annotate", "named_scope", "span"]


def annotate(name: str) -> ContextManager:
    """Host-side profiler range ``name`` around an engine phase."""
    return torch.profiler.record_function(name)


def named_scope(name: str) -> ContextManager:
    """Profiler range ``name`` around a kernel dispatch."""
    return torch.profiler.record_function(name)


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

"""Structured event tracing (``mrsch.trace/v1``); the metrics registry and
profiling hooks are not ported yet."""
from .trace import NULL, TRACE_SCHEMA, BufferTracer, Tracer, canonical_events

__all__ = ["TRACE_SCHEMA", "Tracer", "NULL", "BufferTracer",
           "canonical_events"]

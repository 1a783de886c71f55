"""Telemetry: structured event tracing (``mrsch.trace/v1``), the metrics
registry with Prometheus-style exposition, and profiling hooks.

Everything is off by default: engines take ``tracer=NULL``, the service
and the trainers take ``registry=None``.
"""
from .metrics import (Counter, Gauge, Histogram, JsonlFlusher,
                      MetricsRegistry)
from .profiling import (Span, SpanRecorder, annotate, named_scope, span,
                        span_summary)
from .trace import (NULL, TRACE_SCHEMA, BufferTracer, NullTracer, Tracer,
                    canonical_events, read_trace, to_chrome, trace_lines,
                    write_trace)

__all__ = [
    "TRACE_SCHEMA", "Tracer", "NullTracer", "NULL", "BufferTracer",
    "canonical_events", "trace_lines", "write_trace", "read_trace",
    "to_chrome",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "JsonlFlusher",
    "annotate", "named_scope", "span", "Span", "SpanRecorder",
    "span_summary",
]

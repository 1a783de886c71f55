"""Metrics registry: counters / gauges / histograms with Prometheus-style
text exposition and a periodic JSONL flusher.

Plain Python, the same instruments, label keys, snapshot and exposition
text as the JAX package's ``repro/obs/metrics.py``.  Thread-safe (a lock
per registry and per instrument — the decision service's worker thread
and the trainers write metrics).  Instruments take an optional ``labels`` dict;
each distinct label set is its own time series, exactly like Prometheus
children::

    reg = MetricsRegistry()
    reg.counter("serve_requests_total").inc(3)
    reg.gauge("train_loss", labels={"lane": "0"}).set(0.12)
    reg.histogram("serve_queue_wait_seconds").observe(0.004)
    print(reg.to_prometheus())

``snapshot()`` returns a plain dict for JSON emission; ``JsonlFlusher``
appends one snapshot line per interval (or per manual ``flush()``) so
long-running training/serving processes leave a metrics trail next to
their ``mrsch.trace/v1`` event trace.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "JsonlFlusher",
    "DEFAULT_BUCKETS",
]

#: Default histogram buckets (seconds-flavored, Prometheus-style).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Mapping[str, object]]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: _LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("_v", "_lock")

    def __init__(self) -> None:
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._v += v

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """Last-set value."""

    __slots__ = ("_v", "_lock")

    def __init__(self) -> None:
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._v += v

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each ``le``
    bucket counts observations <= its bound; ``+Inf`` == count)."""

    __slots__ = ("buckets", "_counts", "_count", "_sum", "_min", "_max",
                 "_lock")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * len(self.buckets)
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def summary(self) -> Dict[str, float]:
        n = self._count
        return {
            "count": n, "sum": round(self._sum, 9),
            "mean": round(self._sum / n, 9) if n else 0.0,
            "min": self._min if n else 0.0,
            "max": self._max if n else 0.0,
        }


class MetricsRegistry:
    """Named, labeled instruments + exposition.

    ``counter``/``gauge``/``histogram`` create-or-return the child for
    (name, labels); name collisions across instrument kinds are errors.
    """

    def __init__(self, prefix: str = "mrsch") -> None:
        self.prefix = prefix
        self._lock = threading.Lock()
        self._kinds: Dict[str, str] = {}
        self._children: Dict[str, Dict[_LabelKey, object]] = {}

    def _get(self, kind: str, name: str,
             labels: Optional[Mapping] = None, **kw):
        key = _label_key(labels)
        with self._lock:
            have = self._kinds.get(name)
            if have is None:
                self._kinds[name] = kind
                self._children[name] = {}
            elif have != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {have}")
            series = self._children[name]
            child = series.get(key)
            if child is None:
                cls = {"counter": Counter, "gauge": Gauge,
                       "histogram": Histogram}[kind]
                child = cls(**kw)
                series[key] = child
            return child

    def counter(self, name: str,
                labels: Optional[Mapping] = None) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, labels: Optional[Mapping] = None) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, labels: Optional[Mapping] = None,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get("histogram", name, labels, buckets=buckets)

    # -- exposition -------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition format (type comments + samples)."""
        lines: List[str] = []
        with self._lock:
            items = sorted(self._kinds.items())
            children = {n: dict(s) for n, s in self._children.items()}
        for name, kind in items:
            full = f"{self.prefix}_{name}" if self.prefix else name
            lines.append(f"# TYPE {full} {kind}")
            for key, child in sorted(children[name].items()):
                ls = _label_str(key)
                if kind == "histogram":
                    assert isinstance(child, Histogram)
                    cum_pairs = list(zip(child.buckets, child._counts))
                    for b, c in cum_pairs:
                        lb = _label_str(key + (("le", f"{b:g}"),))
                        lines.append(f"{full}_bucket{lb} {c}")
                    inf_lb = _label_str(key + (("le", "+Inf"),))
                    lines.append(f"{full}_bucket{inf_lb} {child.count}")
                    lines.append(f"{full}_sum{ls} {child.sum:g}")
                    lines.append(f"{full}_count{ls} {child.count}")
                else:
                    lines.append(f"{full}{ls} {child.value:g}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict:
        """Plain-dict view: {name: {label_str or "": value|summary}}."""
        out: Dict = {}
        with self._lock:
            items = sorted(self._kinds.items())
            children = {n: dict(s) for n, s in self._children.items()}
        for name, kind in items:
            series = {}
            for key, child in sorted(children[name].items()):
                k = _label_str(key)
                if kind == "histogram":
                    series[k] = child.summary()
                else:
                    series[k] = child.value
            out[name] = series
        return out


class JsonlFlusher:
    """Periodically append registry snapshots to a JSONL file.

    Use as a context manager (starts/stops the daemon thread) or call
    :meth:`flush` manually.  Each line: ``{"ts": <unix seconds>,
    "metrics": {...}}``.
    """

    def __init__(self, registry: MetricsRegistry, path,
                 interval_s: float = 10.0) -> None:
        self.registry = registry
        self.path = Path(path)
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def flush(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        line = json.dumps({"ts": round(time.time(), 3),
                           "metrics": self.registry.snapshot()},
                          sort_keys=True, separators=(",", ":"))
        with self.path.open("a", encoding="utf-8") as f:
            f.write(line + "\n")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.flush()

    def start(self) -> "JsonlFlusher":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="mrsch-metrics-flusher", daemon=True)
            self._thread.start()
        return self

    def stop(self, final_flush: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_flush:
            self.flush()

    def __enter__(self) -> "JsonlFlusher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

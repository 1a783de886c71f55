"""Micro-batching request queue (max-batch / max-wait coalescing policy).

Concurrent clients submit payloads; a single worker thread drains the
queue and hands each group to a ``process`` callable in one call.  The
coalescing policy is the classic serving one:

* a batch closes as soon as ``max_batch`` payloads are queued, or
* ``max_wait_s`` after the batch's first payload was enqueued (a head
  that already waited out its budget behind the in-flight batch
  dispatches immediately) — ``max_wait_s=0`` (the default) dispatches
  greedily: whatever is queued the moment the worker frees up forms the
  next batch.  Under concurrent
  load requests pile up behind the in-flight batch, so steady-state
  batches grow to the offered concurrency without any artificial delay,
  and an idle service answers a lone request at pure inference latency.

One worker thread does ALL processing, so ``process`` never runs
concurrently with itself — every kernel launch comes from one thread —
and a ``process`` failure is delivered to exactly the tickets of that
batch, never lost.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence


class Ticket:
    """A pending result; ``result()`` blocks until the batch resolves.

    After resolution ``meta`` carries per-request serving telemetry set
    by the worker (``queue_wait_s`` — seconds from enqueue to batch
    dispatch — and ``batch_size`` — how many requests shared the batch).
    """

    __slots__ = ("payload", "enqueued_at", "meta", "_event", "_result",
                 "_error")

    def __init__(self, payload: Any):
        self.payload = payload
        self.enqueued_at = time.monotonic()
        self.meta: Optional[Dict[str, Any]] = None
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None

    def _resolve(self, result: Any) -> None:
        self._result = result
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("decision request timed out")
        if self._error is not None:
            raise self._error
        return self._result


class MicroBatcher:
    """Coalesce concurrent submissions into batched ``process`` calls."""

    def __init__(self, process: Callable[[List[Any]], Sequence[Any]],
                 max_batch: int = 16, max_wait_s: float = 0.0,
                 on_batch: Optional[Callable[[int, List[float], int],
                                             None]] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self._process = process
        # Telemetry observer, called from the worker thread after every
        # successful batch: on_batch(batch_size, per_request_waits_s,
        # queue_depth_after_take).  Failures are swallowed so a broken
        # metrics sink can never take serving down.
        self._on_batch = on_batch
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[Ticket] = []
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # -- instrumentation (read under the lock or after stop())
        self.batches = 0
        self.requests = 0
        self.batch_hist: Dict[int, int] = {}   # batch size -> count

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MicroBatcher":
        with self._lock:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mrsch-microbatcher")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop accepting work; the worker drains what is already queued."""
        with self._cond:
            if not self._running:
                return
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ submit
    def submit(self, payload: Any) -> Ticket:
        ticket = Ticket(payload)
        with self._cond:
            if not self._running:
                raise RuntimeError("batcher is not running (call start())")
            self._queue.append(ticket)
            self._cond.notify()
        return ticket

    # ------------------------------------------------------------ worker
    def _take_batch(self) -> Optional[List[Ticket]]:
        """Block for the next batch; None once stopped and drained."""
        with self._cond:
            while self._running and not self._queue:
                self._cond.wait()
            if not self._queue:
                return None                     # stopped and drained
            if self.max_wait_s > 0:
                # Deadline anchors at the FIRST payload's enqueue: a batch
                # whose head already queued behind the in-flight batch for
                # max_wait is ripe and dispatches immediately, instead of
                # paying a second wait from worker pickup.
                deadline = self._queue[0].enqueued_at + self.max_wait_s
                while (self._running and len(self._queue) < self.max_batch):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
            batch = self._queue[: self.max_batch]
            del self._queue[: len(batch)]
            return batch

    def _loop(self) -> None:
        while (batch := self._take_batch()) is not None:
            dispatched = time.monotonic()
            waits = [max(0.0, dispatched - t.enqueued_at) for t in batch]
            try:
                results = self._process([t.payload for t in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"process returned {len(results)} results for a "
                        f"batch of {len(batch)}")
            except BaseException as e:          # delivered, never lost
                for t in batch:
                    t._fail(e)
                continue
            with self._lock:
                self.batches += 1
                self.requests += len(batch)
                self.batch_hist[len(batch)] = \
                    self.batch_hist.get(len(batch), 0) + 1
                depth = len(self._queue)
            n = len(batch)
            for t, r, w in zip(batch, results, waits):
                t.meta = {"queue_wait_s": w, "batch_size": n}
                t._resolve(r)
            if self._on_batch is not None:
                try:
                    self._on_batch(n, waits, depth)
                except Exception:
                    pass

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, object]:
        with self._lock:
            hist = dict(sorted(self.batch_hist.items()))
            batches, requests = self.batches, self.requests
        return {
            "batches": batches,
            "requests": requests,
            "mean_batch": round(requests / batches, 3) if batches else 0.0,
            "max_batch_seen": max(hist) if hist else 0,
            "batch_hist": hist,
        }

"""Structured event tracing — the ``mrsch.trace/v1`` event schema.

This package records events in memory (:class:`BufferTracer`); the JSONL
writer, reader and Chrome-trace export are not ported yet.  Events are
flat dicts with at least ``ev`` (event kind), ``env`` (environment index,
``-1`` for host-side events) and ``t`` (simulation seconds, or wall
seconds since tracer creation for host events).

The taxonomy (see docs/observability.md):

===================  =======================================================
``sched.decision``   agent picked window slot ``a`` -> job ``jid``;
                     ``q`` = queue length, ``fit`` = 1 if it started now
``sched.reserve``    non-fitting pick reserved at earliest fit (EASY shadow)
``sched.backfill``   backfill pass finished; ``n`` jobs jumped the queue
``job.queued``       job became visible to the scheduler
``job.start``        attempt started (``bf`` = 1 when backfilled)
``job.finish``       terminal success
``job.fail``         terminal failure (requeue bound exhausted / cascade)
``job.requeue``      attempt killed, job re-entered the queue (``n``-th kill)
``fault.drain``      ``units`` units of ``res`` drained (fault injection)
``fault.restore``    drained units restored
``ckpt.reload``      serving params hot-swapped to checkpoint ``step``
``serve.dispatch``   micro-batch of ``n`` requests dispatched at padded
                     ``width``; ``wait_s`` = max queue wait in the batch
``prof.span``        named wall-clock phase of ``dur_s`` seconds
===================  =======================================================

Parity contract: this package's simulator emits a canonical stream
identical to the JAX package's engines for the same scenario and seed.
Every simulation timestamp is canonicalized to its float32 value at
record time (the JAX device engine's clock is f32), and
:func:`canonical_events` imposes one total order that is independent of
engine interleaving.  Wall-clock events (``ckpt.reload``,
``serve.dispatch``, ``prof.span``) are emitted only by harnesses — never
by an engine — and sort after all simulation events.

The default :data:`NULL` tracer (an instance of the no-op base
:class:`Tracer`) keeps instrumented paths allocation-free when
observability is off.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

TRACE_SCHEMA = "mrsch.trace/v1"

__all__ = ["TRACE_SCHEMA", "Tracer", "NULL", "BufferTracer",
           "canonical_events"]


def _t32(t: float) -> float:
    """Canonical trace timestamp: the exact f32 value, as a Python float."""
    return float(np.float32(t))


class Tracer:
    """No-op tracer: every typed emit method does nothing.

    Engines and services call these methods unconditionally; with the
    default instance the calls are plain attribute lookups + empty-body
    invocations (no allocation, no branching at call sites).  Subclass
    and override to record (:class:`BufferTracer`) or stream elsewhere.
    """

    __slots__ = ()

    #: True when emits are recorded — lets hot paths skip building
    #: *derived* payloads (never required for correctness).
    enabled = False

    # -- scheduler events (simulation time) ------------------------------
    def decision(self, env: int, t: float, a: int, jid: int, q: int,
                 fit: int) -> None:
        pass

    def reserve(self, env: int, t: float, jid: int) -> None:
        pass

    def backfill(self, env: int, t: float, n: int) -> None:
        pass

    # -- job lifecycle events (simulation time) --------------------------
    def job_queued(self, env: int, t: float, jid: int) -> None:
        pass

    def job_start(self, env: int, t: float, jid: int, bf: int = 0) -> None:
        pass

    def job_finish(self, env: int, t: float, jid: int) -> None:
        pass

    def job_fail(self, env: int, t: float, jid: int) -> None:
        pass

    def job_requeue(self, env: int, t: float, jid: int, n: int) -> None:
        pass

    # -- fault events (simulation time) ----------------------------------
    def drain(self, env: int, t: float, res: str, units: int) -> None:
        pass

    def restore(self, env: int, t: float, res: str, units: int) -> None:
        pass

    # -- host-side events (wall time; harnesses only) --------------------
    def ckpt_reload(self, step: int) -> None:
        pass

    def dispatch(self, n: int, width: int, wait_s: float) -> None:
        pass

    def span(self, name: str, dur_s: float) -> None:
        pass


#: Module-wide default used by every instrumented constructor.
NULL = Tracer()


class BufferTracer(Tracer):
    """Records every event as a flat dict in :attr:`events`.

    ``meta`` is free-form run metadata (the JSONL header field of the
    ``mrsch.trace/v1`` file format).
    """

    __slots__ = ("events", "meta", "_wall0")

    enabled = True

    def __init__(self) -> None:
        import time
        self.events: List[Dict] = []
        self.meta: Dict = {}
        self._wall0 = time.perf_counter()

    def _wall(self) -> float:
        import time
        return round(time.perf_counter() - self._wall0, 6)

    # -- scheduler --------------------------------------------------------
    def decision(self, env, t, a, jid, q, fit):
        self.events.append({"ev": "sched.decision", "env": int(env),
                            "t": _t32(t), "a": int(a), "jid": int(jid),
                            "q": int(q), "fit": int(fit)})

    def reserve(self, env, t, jid):
        self.events.append({"ev": "sched.reserve", "env": int(env),
                            "t": _t32(t), "jid": int(jid)})

    def backfill(self, env, t, n):
        self.events.append({"ev": "sched.backfill", "env": int(env),
                            "t": _t32(t), "n": int(n)})

    # -- lifecycle --------------------------------------------------------
    def job_queued(self, env, t, jid):
        self.events.append({"ev": "job.queued", "env": int(env),
                            "t": _t32(t), "jid": int(jid)})

    def job_start(self, env, t, jid, bf=0):
        self.events.append({"ev": "job.start", "env": int(env),
                            "t": _t32(t), "jid": int(jid), "bf": int(bf)})

    def job_finish(self, env, t, jid):
        self.events.append({"ev": "job.finish", "env": int(env),
                            "t": _t32(t), "jid": int(jid)})

    def job_fail(self, env, t, jid):
        self.events.append({"ev": "job.fail", "env": int(env),
                            "t": _t32(t), "jid": int(jid)})

    def job_requeue(self, env, t, jid, n):
        self.events.append({"ev": "job.requeue", "env": int(env),
                            "t": _t32(t), "jid": int(jid), "n": int(n)})

    # -- faults -----------------------------------------------------------
    def drain(self, env, t, res, units):
        self.events.append({"ev": "fault.drain", "env": int(env),
                            "t": _t32(t), "res": str(res),
                            "units": int(units)})

    def restore(self, env, t, res, units):
        self.events.append({"ev": "fault.restore", "env": int(env),
                            "t": _t32(t), "res": str(res),
                            "units": int(units)})

    # -- host-side --------------------------------------------------------
    def ckpt_reload(self, step):
        self.events.append({"ev": "ckpt.reload", "env": -1,
                            "t": self._wall(), "step": int(step)})

    def dispatch(self, n, width, wait_s):
        self.events.append({"ev": "serve.dispatch", "env": -1,
                            "t": self._wall(), "n": int(n),
                            "width": int(width),
                            "wait_s": round(float(wait_s), 6)})

    def span(self, name, dur_s):
        self.events.append({"ev": "prof.span", "env": -1,
                            "t": self._wall(), "name": str(name),
                            "dur_s": round(float(dur_s), 6)})


# --------------------------------------------------------------------------
# Canonical ordering
# --------------------------------------------------------------------------
#: Phase rank of simulation events inside one (env, timestamp) group:
#: attempt-end transitions, then queue entries, then drains, restores and
#: finally the decision pass (whose internal emission order is already
#: deterministic and must be preserved — the sort is stable).
_PHASE = {
    "job.finish": 0, "job.fail": 0, "job.requeue": 0,
    "job.queued": 1,
    "fault.drain": 2,
    "fault.restore": 3,
    "sched.decision": 4, "job.start": 4, "sched.reserve": 4,
    "sched.backfill": 4,
}


def canonical_events(events: Iterable[Dict]) -> List[Dict]:
    """One total order over simulation events, independent of how engine
    rounds interleaved environments.  Sort key: (env, t, phase), with
    end/queued/fault phases sub-ordered by (kind, jid) and the decision
    pass kept in (stable) emission order.  Host-side wall-clock events
    keep their emission order after all simulation events."""
    sim, host = [], []
    for e in events:
        (sim if e["ev"] in _PHASE else host).append(e)

    def key(e: Dict) -> Tuple:
        p = _PHASE[e["ev"]]
        sub = (e["ev"], e.get("jid", -1)) if p < 4 else ("", -1)
        return (e["env"], e["t"], p, sub)

    return sorted(sim, key=key) + host

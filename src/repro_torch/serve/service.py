"""The online scheduling-decision service.

``DecisionService`` answers concurrent scheduling-decision requests —
cluster state + queue snapshot as a ``SchedContext``, plus an optional
per-request goal-vector override — with the DFP policy:

    client threads                 worker thread (one, owns all launches)
    submit(ctx [, goal])  ──►  MicroBatcher (max-batch / max-wait)
      encode row                   │  stack rows, pad to shape bucket
      [state|meas|goal|valid]      ▼
                               greedy_actions_packed(net, dfp, packed)
      ticket.result() ◄──      one forward per batch (13 fused-MLP
                               kernel launches on the "kernel" backend)

Requests are encoded in the *client* thread (numpy, cheap) so the worker
does nothing but stack, pad, copy to the device and run the forward;
padding goes to a fixed set of power-of-two bucket widths
(``buckets.BucketCache``).

Weights hot-swap atomically (``update_params``, driven by
``reload.CheckpointWatcher``): the worker snapshots the network reference
once per batch, so in-flight batches finish on the old weights while
every later batch sees the new ones.  The swap checks the incoming
network's parameter names and devices, and its shapes and dtypes through
``checkpoint.check_leaves_compat``, so a network of a different
architecture is rejected and serving continues on the current weights.

The decision function is pure (greedy), so answers equal
``MRSchAgent.select`` on the same context wherever the top two action
values are further apart than the backends' rounding.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..checkpoint import check_leaves_compat
from ..convert import leaves
from ..core.dfp import DFPNetwork, greedy_actions_packed
from ..core.encoding import (decision_row_dim, encode_decision_row,
                             pad_decision_rows)
from ..obs.metrics import MetricsRegistry
from ..obs.trace import NULL, Tracer
from ..sim.simulator import SchedContext
from .batcher import MicroBatcher, Ticket
from .buckets import BucketCache


@dataclass(frozen=True)
class ServeConfig:
    """Knobs of the decision service.

    ``max_wait_s=0`` dispatches greedily (an idle service answers a lone
    request at pure inference latency; concurrent load coalesces behind
    the in-flight batch); raise it to trade a bounded wait for fuller
    batches.  ``warmup`` runs one forward per bucket width at ``start()``
    (on the card, the first also builds and loads the kernel library), so
    the first real request never pays that stall.
    """
    max_batch: int = 16
    max_wait_s: float = 0.0
    warmup: bool = True
    timeout_s: float = 120.0          # decide()/decide_many() wait bound


@dataclass(frozen=True)
class DecisionResponse:
    """A decision plus its per-request serving telemetry.

    ``queue_wait_s`` — seconds the request sat queued before its batch
    dispatched; ``batch_size`` — how many requests shared the batch;
    ``width`` — the padded bucket width the batch dispatched at.
    """
    action: int
    queue_wait_s: float
    batch_size: int
    width: int


class DecisionService:
    """Micro-batched greedy DFP inference with hot-swappable weights.

    ``registry`` (a ``repro_torch.obs.MetricsRegistry``) receives serving
    telemetry — request/batch/reload counters, queue-depth and
    bucket-hit-rate gauges, batch-size and queue-wait histograms.
    ``tracer`` receives ``serve.dispatch`` and ``ckpt.reload``
    ``mrsch.trace/v1`` events.  Both default to no-ops.
    """

    def __init__(self, agent, config: ServeConfig = ServeConfig(), *,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Tracer = NULL):
        self.config = config
        self.registry = registry
        self.tracer = tracer
        self.enc = agent.enc
        self.dfp = agent.dfp
        self.device = agent.device
        self.n_actions = agent.config.window
        self._net = agent.net                # snapshot ref, swapped atomically
        self._params_step: Optional[int] = None
        self._reloads = 0
        self._reload_lock = threading.Lock()
        self._buckets = BucketCache(config.max_batch)
        self._batcher = MicroBatcher(self._process,
                                     max_batch=config.max_batch,
                                     max_wait_s=config.max_wait_s,
                                     on_batch=self._on_batch)
        self._row_dim = decision_row_dim(self.enc, self.n_actions)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "DecisionService":
        self._batcher.start()
        if self.config.warmup:
            self.warmup()
        return self

    def stop(self) -> None:
        self._batcher.stop()

    def __enter__(self) -> "DecisionService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def warmup(self) -> None:
        """One forward at every bucket width."""
        empty = np.zeros((0, self._row_dim), dtype=np.float32)
        for w in self._buckets.widths:
            packed = pad_decision_rows(empty, w, self.enc)
            self._buckets.record(packed.shape[0])
            self._forward(self._net, packed)

    # ------------------------------------------------------------ requests
    def _encode(self, ctx: SchedContext,
                goal: Optional[np.ndarray] = None) -> np.ndarray:
        """One packed decision row (layout: encoding.encode_decision_row)."""
        m = self.enc.n_resources
        if goal is not None:
            goal = np.asarray(goal, dtype=np.float32)
            if goal.shape != (m,):
                raise ValueError(
                    f"goal override must have shape ({m},) — one weight per "
                    f"resource {tuple(self.enc.resource_names)} — got "
                    f"{goal.shape}")
        row = np.zeros(self._row_dim, dtype=np.float32)
        encode_decision_row(self.enc, ctx, self.n_actions, out=row, goal=goal)
        return row

    def submit(self, ctx: SchedContext,
               goal: Optional[np.ndarray] = None) -> Ticket:
        """Enqueue one decision request; returns a ``Ticket`` whose
        ``result()`` is the selected window index."""
        return self._batcher.submit(self._encode(ctx, goal))

    def decide(self, ctx: SchedContext,
               goal: Optional[np.ndarray] = None) -> int:
        """Blocking single decision (submit + wait)."""
        return self.submit(ctx, goal).result(self.config.timeout_s)

    def decide_full(self, ctx: SchedContext,
                    goal: Optional[np.ndarray] = None) -> DecisionResponse:
        """Blocking decision carrying per-request serving telemetry."""
        ticket = self.submit(ctx, goal)
        action = int(ticket.result(self.config.timeout_s))
        meta = ticket.meta or {}
        batch_size = int(meta.get("batch_size", 1))
        return DecisionResponse(
            action=action,
            queue_wait_s=float(meta.get("queue_wait_s", 0.0)),
            batch_size=batch_size,
            width=self._buckets.width_for(batch_size))

    def decide_many(self, ctxs: Sequence[SchedContext],
                    goals: Optional[Sequence] = None) -> np.ndarray:
        """Submit a group of requests, then wait for all of them."""
        if goals is None:
            goals = [None] * len(ctxs)
        elif len(goals) != len(ctxs):
            raise ValueError(f"decide_many: {len(ctxs)} contexts but "
                             f"{len(goals)} goals")
        tickets = [self.submit(c, g) for c, g in zip(ctxs, goals)]
        return np.asarray([t.result(self.config.timeout_s) for t in tickets],
                          dtype=np.int32)

    # ------------------------------------------------------------ inference
    def _forward(self, net: DFPNetwork, packed: np.ndarray) -> np.ndarray:
        rows = torch.from_numpy(packed).to(self.device)
        return greedy_actions_packed(net, self.dfp, rows).cpu().numpy()

    def _process(self, rows: List[np.ndarray]) -> List[int]:
        # One reference read: the whole batch scores on one network,
        # however many swaps land while it is in flight.
        net = self._net
        n = len(rows)
        width = self._buckets.width_for(n)
        packed = pad_decision_rows(np.asarray(rows, dtype=np.float32), width,
                                   self.enc)
        # Account the shape actually dispatched (not the computed bucket),
        # so broken or bypassed padding shows up in the stats.
        self._buckets.record(packed.shape[0])
        acts = self._forward(net, packed)
        return [int(x) for x in acts[:n]]

    def _on_batch(self, n: int, waits: List[float], depth: int) -> None:
        """Worker-thread telemetry hook (see MicroBatcher.on_batch)."""
        width = self._buckets.width_for(n)
        self.tracer.dispatch(n, width, max(waits) if waits else 0.0)
        reg = self.registry
        if reg is None:
            return
        reg.counter("serve_requests_total").inc(n)
        reg.counter("serve_batches_total").inc()
        reg.counter("serve_batch_rows_total", {"width": width}).inc(n)
        reg.gauge("serve_queue_depth").set(depth)
        reg.histogram("serve_batch_size",
                      buckets=self._buckets.widths).observe(n)
        wait_hist = reg.histogram("serve_queue_wait_seconds")
        for w in waits:
            wait_hist.observe(w)
        b = self._buckets.stats()
        hit = (b["bucket_hits"] / b["dispatches"]) if b["dispatches"] else 0.0
        reg.gauge("serve_bucket_hit_rate").set(hit)

    # ------------------------------------------------------------ hot swap
    @property
    def params(self) -> DFPNetwork:
        """The currently served network (swap via update_params)."""
        return self._net

    @property
    def params_step(self) -> Optional[int]:
        return self._params_step

    def update_params(self, net: DFPNetwork,
                      step: Optional[int] = None) -> None:
        """Atomically swap the served network (zero-downtime reload).

        The incoming network must match the current one parameter for
        parameter (name, device; shape and dtype through
        ``check_leaves_compat``); otherwise ``ValueError`` and the service
        keeps serving the current weights.  In-flight batches finish on
        the network they snapshot; every batch formed after the swap
        scores on the new one.
        """
        if not isinstance(net, DFPNetwork):
            raise ValueError(f"update_params: expected a DFPNetwork, got "
                             f"{type(net).__name__}")
        old, new = leaves(self._net), leaves(net)
        if [n for n, _ in old] != [n for n, _ in new]:
            raise ValueError("update_params: incompatible parameter names — "
                             f"got {[n for n, _ in new]}, expected "
                             f"{[n for n, _ in old]}")
        check_leaves_compat([p for _, p in old], [p for _, p in new],
                            context="update_params")
        for (name, o), (_, g) in zip(old, new):
            if o.device != g.device:
                raise ValueError(
                    f"update_params: parameter {name} device mismatch — got "
                    f"{g.device}, expected {o.device}")
        with self._reload_lock:
            self._net = net                  # atomic reference swap
            self._params_step = step
            self._reloads += 1
        self.tracer.ckpt_reload(step if step is not None else -1)
        if self.registry is not None:
            self.registry.counter("serve_reloads_total").inc()

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, object]:
        with self._reload_lock:
            reloads, step = self._reloads, self._params_step
        return {
            **self._batcher.stats(),
            "buckets": self._buckets.stats(),
            "reloads": reloads,
            "params_step": step,
        }

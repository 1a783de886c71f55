"""Batched multi-environment rollout engine (the lockstep vector engine).

``VectorSimulator`` advances N independent trace simulations in lockstep
*rounds*: each round gathers the pending ``SchedContext`` from every
environment that needs a decision, hands the whole batch to the policy in
ONE call (``select_batch`` — a single DFP forward for the MRSch agent),
scatters the selected actions back, and lets each environment's event
loop run to its next decision point.  Environments that drain their event
queues drop out of later rounds — or, when a ``refill`` callback is
supplied (the vectorised trainer in ``repro_torch.core.train``), are
re-seeded at once with their next trace so the decision batch stays wide
across a whole curriculum.

Per-environment trajectories are identical to running each ``Simulator``
alone: the engine only interleaves *when* decisions are computed, never
what each environment observes — each context is built from that
environment's own cluster and queue at its own simulation clock.

Batching requires a policy whose decision is a function of the context
(the MRSch agent, FCFS, ...).  Policies whose ``select_batch`` accepts a
``slots`` keyword (the MRSch agent in training mode) also receive the
environment index of every context, so per-environment state such as
episode accumulators stays separated.  Policies that keep cross-call
state keyed to one trace run through the sequential per-environment
fallback, which this engine uses whenever the policy lacks
``select_batch``.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Callable, List, Optional, Protocol, Sequence

import numpy as np
import torch

from ..obs.profiling import annotate
from ..obs.trace import NULL, Tracer
from .cluster import ResourceSpec
from .job import Job
from .lifecycle import FaultSchedule
from .simulator import SchedContext, SimConfig, SimResult, Simulator


class BatchSchedulingPolicy(Protocol):
    """The batched host stage of the ``Policy`` protocol;
    ``repro_torch.core.policy_api.WindowPolicy`` derives it from
    ``score_window``."""

    def select_batch(self, ctxs: Sequence[SchedContext]) -> np.ndarray:
        """Return one window index per context."""
        ...


@dataclass
class VectorStats:
    """Instrumentation of the lockstep engine."""
    rounds: int = 0              # lockstep rounds executed
    decisions: int = 0           # total decisions across environments
    policy_calls: int = 0        # batched policy invocations
    max_batch: int = 0           # widest decision batch seen
    episodes: int = 0            # environment episodes completed

    def as_dict(self) -> dict:
        return {"rounds": self.rounds, "decisions": self.decisions,
                "policy_calls": self.policy_calls,
                "max_batch": self.max_batch, "episodes": self.episodes}


class VectorSimulator:
    """Run N simulators in lockstep with batched policy inference.

    Parameters
    ----------
    sims:   the environments; each may carry its own trace and config.
    policy: shared decision policy.  If omitted, every simulator's own
            ``policy`` answers its contexts one at a time (lockstep order
            is kept but nothing batches).
    """

    def __init__(self, sims: Sequence[Simulator], policy=None):
        self.sims = list(sims)
        self.policy = policy
        self.stats = VectorStats()
        select_batch = getattr(policy, "select_batch", None)
        self._batched = select_batch is not None
        self._slot_aware = False
        if self._batched:
            try:
                params = inspect.signature(select_batch).parameters
                self._slot_aware = "slots" in params
            except (TypeError, ValueError):
                pass

    @staticmethod
    def _fault_list(faults, n: int):
        """Normalize the ``faults`` argument: None, one schedule shared by
        every environment, or one (possibly None) schedule per jobset."""
        if faults is None or isinstance(faults, FaultSchedule):
            return [faults] * n
        faults = list(faults)
        if len(faults) != n:
            raise ValueError(
                f"got {len(faults)} fault schedules for {n} jobsets")
        return faults

    @staticmethod
    def _env_ids(env_ids, n: int):
        if env_ids is None:
            return list(range(n))
        env_ids = [int(e) for e in env_ids]
        if len(env_ids) != n:
            raise ValueError(f"got {len(env_ids)} env ids for {n} jobsets")
        return env_ids

    @classmethod
    def from_jobsets(cls, resources: Sequence[ResourceSpec],
                     jobsets: Sequence[Sequence[Job]], policy,
                     config: SimConfig | None = None, *,
                     faults=None, tracer: Tracer = NULL,
                     env_ids=None) -> "VectorSimulator":
        """One environment per jobset, all sharing cluster spec and policy.

        ``tracer`` is shared by every environment; ``env_ids`` (default
        ``0..N-1``) tags each environment's events so one trace can hold
        a whole run.
        """
        flist = cls._fault_list(faults, len(jobsets))
        eids = cls._env_ids(env_ids, len(jobsets))
        sims = [Simulator(resources, jobs, policy, config, faults=f,
                          tracer=tracer, env=e)
                for jobs, f, e in zip(jobsets, flist, eids)]
        return cls(sims, policy=policy)

    @classmethod
    def from_factory(cls, resources: Sequence[ResourceSpec],
                     jobsets: Sequence[Sequence[Job]],
                     policy_factory: Callable[[], object],
                     config: SimConfig | None = None, *,
                     faults=None, tracer: Tracer = NULL,
                     env_ids=None) -> "VectorSimulator":
        """One FRESH policy instance per environment, lockstep kept.

        For stateful sequential policies that must not share state across
        lanes: each environment answers its own contexts through its own
        instance via the engine's sequential fallback.  Nothing batches,
        but the round interleaving — and so any refill/on_round driving —
        matches the batched policies.
        """
        flist = cls._fault_list(faults, len(jobsets))
        eids = cls._env_ids(env_ids, len(jobsets))
        sims = [Simulator(resources, jobs, policy_factory(), config, faults=f,
                          tracer=tracer, env=e)
                for jobs, f, e in zip(jobsets, flist, eids)]
        return cls(sims, policy=None)

    # ---------------------------------------------------------------- run
    def _advance(self, i: int,
                 refill: Optional[Callable[[int, SimResult],
                                           Optional[Simulator]]],
                 results: List[SimResult]) -> Optional[SchedContext]:
        """Step env ``i`` to its next decision, refilling drained traces."""
        while True:
            ctx = self.sims[i].next_decision()
            if ctx is not None:
                return ctx
            if refill is None:
                return None
            self.stats.episodes += 1
            result = self.sims[i].result()
            results.append(result)
            prev_policy = self.sims[i].policy
            nxt = refill(i, result)
            if nxt is None:
                return None
            if nxt.policy is None:
                # Carry the slot's policy instance across the refill: a
                # factory-built engine owns per-environment policy state
                # that must survive the trace swap.
                nxt.policy = prev_policy
            self.sims[i] = nxt

    def run(self, refill=None, on_round=None) -> List[SimResult]:
        """Drive all environments to completion; return their results.

        refill(i, result) — called the moment environment ``i`` drains;
            may return a fresh ``Simulator`` to continue collecting in
            that slot (or None to retire it).  With a refill callback the
            returned list holds every completed episode in completion
            order; without one it holds exactly one result per slot, in
            slot order.
        on_round(round_idx, n_live) — called after each lockstep round's
            actions are applied; the vectorised trainer hooks interleaved
            gradient steps here.
        """
        results: List[SimResult] = []
        pending: List[Optional[SchedContext]] = [
            self._advance(i, refill, results)
            for i in range(len(self.sims))]
        while True:
            live = [i for i, c in enumerate(pending) if c is not None]
            if not live:
                break
            ctxs = [pending[i] for i in live]
            with annotate("mrsch.vector.policy_select"):
                if self._slot_aware:
                    actions = np.asarray(self.policy.select_batch(
                        ctxs, slots=live))
                elif self._batched:
                    actions = np.asarray(self.policy.select_batch(ctxs))
                else:
                    actions = [self.sims[i].policy.select(c)
                               for i, c in zip(live, ctxs)]
            self.stats.policy_calls += 1 if self._batched else len(live)
            self.stats.decisions += len(live)
            self.stats.max_batch = max(self.stats.max_batch, len(live))
            for i, a in zip(live, actions):
                self.sims[i].post_action(int(a))
                pending[i] = self._advance(i, refill, results)
            if on_round is not None:
                on_round(self.stats.rounds, len(live))
            self.stats.rounds += 1
        if refill is None:
            return [s.result() for s in self.sims]
        return results


def run_traces(resources: Sequence[ResourceSpec],
               jobsets: Sequence[Sequence[Job]], policy, window: int = 10,
               backfill: bool = True, faults=None) -> List[SimResult]:
    """Batched counterpart of ``run_trace``: one lockstep environment per
    jobset, one result per jobset in order."""
    vec = VectorSimulator.from_jobsets(
        resources, jobsets, policy,
        SimConfig.for_engine("vector", window=window, backfill=backfill),
        faults=faults)
    return vec.run()

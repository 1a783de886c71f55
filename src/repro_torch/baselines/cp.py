"""Constraint/optimization dispatcher: window packing as a small ILP (the
JAX package's ``repro/baselines/cp.py``, numpy only, copied so this
package imports nothing of that one).

After accasim's hybrid constraint-programming scheduler (SNIPPETS.md
snippet 1): each scheduling round poses the current window as a
packing problem — pick the subset of window jobs maximizing summed
dispatch value subject to the cluster's free multi-resource capacities
— and dispatches from the optimal subset.  Job value combines the
EWT-normalized priority PRB uses (so the two accasim dispatchers share
a priority model) with a utilization term rewarding big asks that the
free pool can absorb.

The solve is exact for small windows: all ``2^W`` subsets are
enumerated with one vectorized mask product (W <= ``exact_window``,
the paper-standard W=10 costs a 1024-row matmul per decision).  Wider
windows fall back to the classic greedy LP-relaxation ordering (value
per weighted unit of scarce demand) plus one swap-improvement pass.

The dispatcher is stateless — every decision re-solves from the
context alone — so one instance batches across ``VectorSimulator``
lanes via the host ``select_batch`` loop.  It has no pure traced form
(the solve is combinatorial), so like ``GAOptimizer`` it reports
``supports_device() == False``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from ..sim.simulator import SchedContext

_MASKS: Dict[int, np.ndarray] = {}   # W -> (2^W, W) subset masks


def _subset_masks(w: int) -> np.ndarray:
    m = _MASKS.get(w)
    if m is None:
        m = ((np.arange(1 << w)[:, None] >> np.arange(w)) & 1
             ).astype(np.float64)
        _MASKS[w] = m
    return m


@dataclass(frozen=True)
class CPConfig:
    window: int = 10
    exact_window: int = 12           # enumerate subsets up to this W
    base_ewt_s: float = 3600.0       # shared EWT priority model (see prb.py)
    walltime_factor: float = 0.5
    demand_factor: float = 4.0
    min_wait_s: float = 60.0
    util_weight: float = 0.5         # value bonus per unit of demand fraction
    swap_passes: int = 1             # improvement passes in greedy mode


class CPDispatcher:
    """Optimal-subset window dispatcher (host-side stages only)."""

    # No pure traced form: the engines must use the host stages.
    init_state = None
    score_window = None

    def __init__(self, config: CPConfig = CPConfig()):
        self.config = config

    # ----------------------------------------------------------- valuation
    def _values(self, ctx: SchedContext, fracs: np.ndarray) -> np.ndarray:
        cfg = self.config
        demand = fracs.sum(axis=1)
        wall = np.array([j.walltime for j in ctx.window])
        wait = np.array([max(ctx.now - j.submit, 0.0) for j in ctx.window])
        ewt = (cfg.base_ewt_s + cfg.walltime_factor * wall
               + cfg.demand_factor * 3600.0 * demand)
        value = (wait + cfg.min_wait_s) / ewt + cfg.util_weight * demand
        # FCFS tiebreak keeps the solve deterministic under equal values.
        return value - 1e-9 * np.arange(len(ctx.window))

    def _solve(self, free: np.ndarray, fracs_units: np.ndarray,
               values: np.ndarray) -> np.ndarray:
        """Boolean chosen-mask maximizing sum(values) within ``free``."""
        n = len(values)
        if n <= self.config.exact_window:
            masks = _subset_masks(n)
            feasible = (masks @ fracs_units <= free + 1e-9).all(axis=1)
            totals = np.where(feasible, masks @ values, -np.inf)
            return masks[int(np.argmax(totals))] > 0.5
        # Greedy LP-relaxation: value per weighted unit of scarce demand.
        scarce = 1.0 / np.maximum(free, 1.0)
        density = values / (fracs_units @ scarce + 1e-9)
        order = np.argsort(-density, kind="stable")
        chosen = np.zeros(n, bool)
        residual = free.astype(np.float64).copy()
        for i in order:
            if (fracs_units[i] <= residual + 1e-9).all():
                chosen[i] = True
                residual -= fracs_units[i]
        for _ in range(self.config.swap_passes):
            improved = False
            for i in np.argsort(-values, kind="stable"):
                if chosen[i]:
                    continue
                for k in np.argsort(values, kind="stable"):
                    if not chosen[k] or values[k] >= values[i]:
                        continue
                    if (fracs_units[i] - fracs_units[k]
                            <= residual + 1e-9).all():
                        chosen[k] = False
                        chosen[i] = True
                        residual += fracs_units[k] - fracs_units[i]
                        improved = True
                        break
            if not improved:
                break
        return chosen

    # ------------------------------------------------------------- stages
    def _select_one(self, ctx: SchedContext) -> int:
        names = ctx.cluster.names
        caps = np.array([max(ctx.cluster.capacities[n], 1) for n in names],
                        dtype=np.float64)
        free = np.array([ctx.cluster.free[n] for n in names], dtype=np.float64)
        units = np.array([[j.demands.get(n, 0) for n in names]
                          for j in ctx.window], dtype=np.float64)
        values = self._values(ctx, units / caps)
        chosen = self._solve(free, units, values)
        if chosen.any():
            # Dispatch the most valuable member of the optimal subset; the
            # simulator starts it and re-asks, so the round re-solves with
            # the residual capacity.
            return int(np.argmax(np.where(chosen, values, -np.inf)))
        # Nothing fits: hand the highest-priority job to the reservation +
        # EASY-backfill machinery.
        return int(np.argmax(values))

    def select(self, ctx: SchedContext) -> int:
        return self._select_one(ctx)

    def select_batch(self, ctxs: Sequence[SchedContext]) -> np.ndarray:
        return np.array([self._select_one(c) for c in ctxs], dtype=np.int32)

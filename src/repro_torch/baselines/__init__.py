"""Literature baseline zoo (the JAX package's ``repro/baselines``).

Every entrant implements the unified ``repro_torch.core.policy_api``
protocol, so the evaluation matrix and the standing tournament
(``repro_torch.eval.tournament``) run them batched on ``VectorSimulator``
exactly like the paper's own four methods:

* ``PRBPolicy``    — Priority Rules Based backfill with Estimated
                     Waiting Time priorities (accasim's PRB dispatcher,
                     after Borghesi et al., CP 2015).
* ``CPDispatcher`` — constraint/optimization dispatcher: each round's
                     window packing solved as a small ILP (exact subset
                     enumeration for W <= ``exact_window``, greedy
                     density relaxation + swap pass beyond), after
                     accasim's hybrid-CP scheduler.
* ``DRASPolicy``   — DRAS-style two-level agent: a window-select
                     network plus a reserve/backfill head
                     (Fan & Lan, arXiv:2102.06243).
* ``CoSchedPolicy``— RL co-scheduler variant scoring node-sharing
                     pairs: complementary window jobs boost each other
                     (after arXiv:2401.09706).

See ``docs/baselines.md`` for each policy's knobs and provenance.
"""
from .cosched import CoSchedConfig, CoSchedPolicy
from .cp import CPConfig, CPDispatcher
from .dras import DRASConfig, DRASPolicy
from .prb import PRBConfig, PRBPolicy

__all__ = [
    "PRBConfig", "PRBPolicy",
    "CPConfig", "CPDispatcher",
    "DRASConfig", "DRASPolicy",
    "CoSchedConfig", "CoSchedPolicy",
]

"""Job and resource-request model for the multi-resource cluster simulator."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np


@dataclass
class Job:
    """A rigid parallel HPC job.

    ``demands`` maps resource name -> requested units (integer), e.g.
    ``{"node": 512, "bb": 40, "power": 60}``.  Burst buffer is in units
    (default 1 TB/unit); power in kW of *incremental* draw above idle.

    Workflow/fault extensions (see ``repro_torch.sim.lifecycle``):

    - ``deps``: jids of parent jobs; this job is HELD until every parent
      FINISHes (dangling jids — parents not present in the jobset — are
      treated as already satisfied, so sampled sub-traces stay runnable).
    - ``think_time``: seconds after the last parent finishes before this
      job becomes eligible (SWF field 18).
    - ``fail_times``: per-attempt failure points, in seconds after the
      attempt starts.  Attempt ``k`` dies at ``fail_times[k]`` if that is
      strictly less than ``runtime``; attempts beyond ``len(fail_times)``
      (and entries >= runtime) run to completion.
    """

    jid: int
    submit: float                       # submission time (seconds)
    runtime: float                      # actual runtime (seconds)
    walltime: float                     # user estimate (seconds), >= runtime
    demands: Dict[str, int] = field(default_factory=dict)

    # Mutable scheduling state (current attempt)
    start: float = -1.0
    end: float = -1.0

    # Workflow / fault spec (fixed per trace, survives ``copy()``)
    deps: Tuple[int, ...] = ()
    think_time: float = 0.0
    fail_times: Tuple[float, ...] = ()

    # Lifecycle state (reset by ``copy()``); ``state`` holds a
    # ``repro_torch.sim.lifecycle`` state constant (HELD == 0).
    state: int = 0
    first_start: float = -1.0           # start of the FIRST attempt
    requeues: int = 0                   # completed failed attempts
    failed_work: float = 0.0            # node-seconds lost to killed attempts

    @property
    def started(self) -> bool:
        return self.first_start >= 0.0 or self.start >= 0.0

    @property
    def wait(self) -> float:
        """Queue wait measured from submission to the FIRST attempt.

        Requeued jobs keep the wait of their first start — a job that ran,
        failed, and ran again did not wait longer for service.
        """
        s = self.first_start if self.first_start >= 0.0 else self.start
        return s - self.submit

    @property
    def slowdown(self) -> float:
        return (self.wait + self.runtime) / max(self.runtime, 1.0)

    def bounded_slowdown(self, tau: float = 10.0) -> float:
        return max(1.0, (self.wait + self.runtime) / max(self.runtime, tau))

    def demand_fraction(self, capacities: Dict[str, int]) -> np.ndarray:
        """P_ij of Eq. (1): requested fraction of each resource's capacity."""
        return np.array(
            [self.demands.get(r, 0) / max(c, 1) for r, c in capacities.items()],
            dtype=np.float64,
        )

    def demand_row(self, names: tuple) -> tuple:
        """Demanded units ordered by ``names``, cached on the instance.

        Demands are fixed once a trace is built (simulators work on
        copies), and this row is consumed on every scheduling decision by
        the Eq. (1) goal computation — caching it removes a per-decision
        dict-lookup loop from the hot path.
        """
        cached = self.__dict__.get("_demand_row")
        if cached is not None and cached[0] == names:
            return cached[1]
        row = tuple(float(self.demands.get(n, 0)) for n in names)
        self.__dict__["_demand_row"] = (names, row)
        return row

    def copy(self) -> "Job":
        return Job(self.jid, self.submit, self.runtime, self.walltime,
                   dict(self.demands), deps=self.deps,
                   think_time=self.think_time, fail_times=self.fail_times)

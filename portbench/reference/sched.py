"""Plain scheduling reference: one trace on one Theta-like cluster, EASY
backfill, the paper's state encoding (arXiv:2403.16298 §III-A, Eq. 1) and
the queue-as-tokens layout, written from their definitions in NumPy.

``replay`` follows a list of actions (the program's, in decision order)
and returns, per decision, the packed row the scheduler observed there
and the number of valid window slots, and at the end each job's start
and end time.  It does not choose actions: the checker scores the rows
with the plain network and judges the program's choice against them.

Semantics (the rules of the device engine this reference is held to):

* one clock; at each event time every attempt end is applied before the
  jobs that arrive at that time join the queue, and a scheduling pass
  opens if the queue is not empty;
* the queue is the waiting jobs in (submit, jid) order; a decision picks
  slot ``a`` of its first W jobs; a job that fits starts at once on the
  lowest-index free units of each resource, and the pass goes on; the
  first that does not fit is reserved at its earliest fit time under the
  running jobs' walltime estimates, EASY backfill starts, in queue
  order, every other waiting job that fits now and either ends (by its
  walltime) before the reservation or leaves the reserved job's units
  free at it, and the pass ends;
* times are whole seconds (the mix's ``time_resolution_s``), so float32
  and float64 clocks agree exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

TTF_HORIZON = 30.0 * 86400.0        # time-to-free clamp (drained units)


@dataclass(frozen=True)
class Layout:
    """What a decision row holds."""
    caps: tuple                     # units per resource
    window: int                     # W
    state_module: str               # "mlp" or "attention"
    queue_cap: int = 0              # Q (attention)
    time_scale: float = 86400.0

    @property
    def n_resources(self) -> int:
        return len(self.caps)

    @property
    def state_dim(self) -> int:
        R = self.n_resources
        if self.state_module == "attention":
            return self.queue_cap * (R + 2) + 1 + 2 * R
        return self.window * (R + 2) + 2 * int(sum(self.caps))

    @property
    def row_dim(self) -> int:
        return self.state_dim + 2 * self.n_resources + self.window


@dataclass
class Replay:
    rows: np.ndarray                # (D, row_dim) float32
    n_valid: np.ndarray             # (D,) int: valid window slots
    queue_len: np.ndarray           # (D,) int: waiting jobs at the decision
    start: np.ndarray               # (J,) float64, -1 never started
    end: np.ndarray                 # (J,) float64, -1 never started
    unused_actions: int             # actions left when the trace ended
    missing_actions: int            # decisions the action list did not reach
    invalid_actions: int            # actions outside the valid window


class _Cluster:
    def __init__(self, caps: Sequence[int]):
        self.caps = [int(c) for c in caps]
        self.release = [np.zeros(c) for c in self.caps]     # 0 = free
        self.free = list(self.caps)
        self.units = {}                                      # job -> [idx]
        self.est_end = {}                                    # job -> time

    def fits(self, dem) -> bool:
        return all(dem[r] <= self.free[r] for r in range(len(self.caps)))

    def start(self, j: int, dem, est: float) -> None:
        idx = []
        for r in range(len(self.caps)):
            u = np.flatnonzero(self.release[r] == 0.0)[:int(dem[r])]
            self.release[r][u] = est
            self.free[r] -= len(u)
            idx.append(u)
        self.units[j] = idx
        self.est_end[j] = est

    def finish(self, j: int) -> None:
        for r, u in enumerate(self.units.pop(j)):
            self.release[r][u] = 0.0
            self.free[r] += len(u)
        del self.est_end[j]

    def earliest_fit(self, dem, now: float) -> float:
        t = now
        for r in range(len(self.caps)):
            need = int(dem[r])
            if need <= self.free[r]:
                continue
            if need > self.caps[r]:
                return float("inf")
            t = max(t, float(np.sort(self.release[r])[need - 1]))
        return t


def _goal(cl: _Cluster, queue: List[int], dem, wall, now: float, R: int):
    """Eq. (1): each resource's outstanding demand-time (queued jobs at
    their walltime, running ones at their remaining estimate) over its
    capacity, normalised to sum 1 (uniform when nothing is outstanding)."""
    acc = wall[queue] @ dem[queue] if queue else np.zeros(R)
    if cl.est_end:
        run = np.fromiter(cl.est_end, np.int64, len(cl.est_end))
        rem = np.fromiter(cl.est_end.values(), np.float64, len(run)) - now
        acc = acc + np.where(rem > 0.0, rem, 0.0) @ dem[run]
    dt = acc / np.maximum(np.asarray(cl.caps, np.float64), 1.0)
    total = dt.sum()
    if total <= 0:
        return np.full(R, 1.0 / R)
    return dt / total


def _row(lay: Layout, cl: _Cluster, queue: List[int], trace, now: float,
         out: np.ndarray) -> int:
    """Fill one decision row [state | meas | goal | valid]; returns the
    number of valid window slots."""
    R, W, ts = lay.n_resources, lay.window, lay.time_scale
    caps = np.asarray(cl.caps, np.float64)
    dem, wall, sub = trace.demands, trace.walltime, trace.submit
    slots = lay.queue_cap if lay.state_module == "attention" else W
    q = np.asarray(queue[:slots], np.int64)
    if len(q):                       # per job [P_1 .. P_R, walltime, queued]
        feats = np.concatenate([dem[q] / caps, (wall[q] / ts)[:, None],
                                ((now - sub[q]) / ts)[:, None]], axis=1)
        out[:len(q) * (R + 2)] = feats.reshape(-1)
    off = slots * (R + 2)
    if lay.state_module == "attention":
        out[off] = min(len(queue), slots)
        off += 1
        for r in range(R):
            rel = cl.release[r]
            busy = rel > 0.0
            nb = int(busy.sum())
            out[off] = 1.0 - nb / cl.caps[r]
            if nb:
                out[off + 1] = (np.clip(rel[busy] - now, 0.0, TTF_HORIZON)
                                .sum() / nb / ts)
            off += 2
    else:
        for r in range(R):
            rel, c = cl.release[r], cl.caps[r]
            busy = rel > 0.0
            out[off:off + c] = ~busy
            out[off + c:off + 2 * c] = np.where(
                busy, np.clip(rel - now, 0.0, TTF_HORIZON), 0.0) / ts
            off += 2 * c
    sd = lay.state_dim
    out[sd:sd + R] = [(cl.caps[r] - cl.free[r]) / cl.caps[r]
                      for r in range(R)]
    out[sd + R:sd + 2 * R] = _goal(cl, queue, dem, wall, now, R)
    n_valid = min(len(queue), W)
    out[sd + 2 * R:sd + 2 * R + n_valid] = 1.0
    return n_valid


def replay(lay: Layout, trace, actions: Sequence[int]) -> Replay:
    """Run ``trace`` to its end, taking ``actions`` in decision order."""
    J = len(trace.submit)
    sub, run, wall = trace.submit, trace.runtime, trace.walltime
    dem = trace.demands.astype(np.int64)
    cl = _Cluster(lay.caps)
    start, end = np.full(J, -1.0), np.full(J, -1.0)
    queue: List[int] = []
    running = {}                                    # job -> end time
    rows, n_valid, qlen = [], [], []
    nxt, k, invalid, missing = 0, 0, 0, 0
    now, in_pass = 0.0, False

    def launch(j):
        start[j], end[j] = now, now + run[j]
        cl.start(j, dem[j], now + wall[j])
        running[j] = end[j]
        queue.remove(j)

    while True:
        if in_pass and queue:
            row = np.zeros(lay.row_dim, np.float32)
            nv = _row(lay, cl, queue, trace, now, row)
            rows.append(row)
            n_valid.append(nv)
            qlen.append(len(queue))
            if k >= len(actions):
                missing += 1
                break
            a = int(actions[k])
            k += 1
            if not 0 <= a < nv:
                invalid += 1
                a = min(max(a, 0), nv - 1)
            j = queue[a]
            if cl.fits(dem[j]):
                launch(j)
                continue
            t_res = cl.earliest_fit(dem[j], now)
            if np.isfinite(t_res):
                shadow = [int((cl.release[r] <= t_res).sum()) - dem[j][r]
                          for r in range(lay.n_resources)]
                for b in list(queue):
                    if b == j or not cl.fits(dem[b]):
                        continue
                    before = now + wall[b] <= t_res
                    if before or all(dem[b][r] <= shadow[r]
                                     for r in range(lay.n_resources)):
                        if not before:
                            shadow = [shadow[r] - dem[b][r]
                                      for r in range(lay.n_resources)]
                        launch(b)
            in_pass = False
            continue
        t_arr = sub[nxt] if nxt < J else np.inf
        t_end = min(running.values()) if running else np.inf
        now = min(t_arr, t_end)
        if not np.isfinite(now):
            break
        for j in [j for j, e in running.items() if e == now]:
            cl.finish(j)
            del running[j]
        while nxt < J and sub[nxt] == now:
            queue.append(nxt)
            nxt += 1
        in_pass = True
    width = lay.row_dim
    return Replay(
        rows=np.stack(rows) if rows else np.zeros((0, width), np.float32),
        n_valid=np.asarray(n_valid, np.int64),
        queue_len=np.asarray(qlen, np.int64), start=start, end=end,
        unused_actions=len(actions) - k, missing_actions=missing,
        invalid_actions=invalid)

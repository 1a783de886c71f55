"""Episodic experience buffer for DFP training (paper §II-B, §III-C), in
numpy, as the JAX package's ``repro/core/replay.py`` keeps it.

DFP is supervised on future measurement deltas rather than a scalar
reward, so experience stays grouped by episode: one row per scheduling
decision — (state, measurement, goal, action) — and the targets
f[tau, m] = m_{t+tau} - m_t are made at sample time, with the offsets
that cross the episode's end masked out of the loss.  ``EpisodeRecorder``
accumulates one trajectory; ``VectorEpisodeRecorder`` keeps one
accumulator per environment slot, so the lockstep engine
(``repro_torch.sim.vector``) can collect N interleaved trajectories
without mixing their future-delta targets; ``ReplayBuffer`` holds
finished episodes up to a row budget and serves uniform minibatches.  Sampling draws from the
caller's ``rng`` in the reference's order, so one seed gives the same
minibatches in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class Episode:
    states: np.ndarray       # (n, state_dim) float32
    meas: np.ndarray         # (n, M)
    goals: np.ndarray        # (n, M)
    actions: np.ndarray      # (n,) int32


class EpisodeRecorder:
    def __init__(self):
        self._s: List[np.ndarray] = []
        self._m: List[np.ndarray] = []
        self._g: List[np.ndarray] = []
        self._a: List[int] = []

    def record(self, state, meas, goal, action: int) -> None:
        self._s.append(np.asarray(state, np.float32))
        self._m.append(np.asarray(meas, np.float32))
        self._g.append(np.asarray(goal, np.float32))
        self._a.append(int(action))

    def __len__(self) -> int:
        return len(self._a)

    def finish(self) -> Optional[Episode]:
        if not self._a:
            return None
        ep = Episode(states=np.stack(self._s), meas=np.stack(self._m),
                     goals=np.stack(self._g),
                     actions=np.asarray(self._a, np.int32))
        self._s, self._m, self._g, self._a = [], [], [], []
        return ep


class VectorEpisodeRecorder:
    """Per-environment episode accumulators for batched collection.

    The lockstep engine interleaves decisions from N environments; routing
    each transition to its own slot keeps every episode contiguous, so the
    DFP future-measurement targets stay well defined.  Slots are created
    on first use, so one recorder serves any batch width.
    """

    def __init__(self, n_envs: int = 0):
        self._slots: Dict[int, EpisodeRecorder] = {
            i: EpisodeRecorder() for i in range(n_envs)}

    def slot(self, i: int) -> EpisodeRecorder:
        rec = self._slots.get(i)
        if rec is None:
            rec = self._slots[i] = EpisodeRecorder()
        return rec

    def record(self, i: int, state, meas, goal, action: int) -> None:
        self.slot(i).record(state, meas, goal, action)

    def finish(self, i: int) -> Optional[Episode]:
        """Close slot ``i``'s episode (None if nothing was recorded)."""
        return self.slot(i).finish()

    def pending_rows(self) -> int:
        return sum(len(r) for r in self._slots.values())

    def __len__(self) -> int:
        return len(self._slots)


class ReplayBuffer:
    def __init__(self, offsets: Sequence[int], capacity_rows: int = 200_000):
        self.offsets = np.asarray(offsets, np.int64)
        self.capacity_rows = capacity_rows
        self.episodes: List[Episode] = []
        self._rows = 0

    def add(self, ep: Episode) -> None:
        self.episodes.append(ep)
        self._rows += len(ep.actions)
        while self._rows > self.capacity_rows and len(self.episodes) > 1:
            old = self.episodes.pop(0)
            self._rows -= len(old.actions)

    @property
    def rows(self) -> int:
        return self._rows

    def sample(self, rng: np.random.Generator,
               batch: int) -> Dict[str, np.ndarray]:
        """Uniform sample over all stored rows; targets computed on the fly.
        Rows are gathered episode by episode with fancy indexing."""
        sizes = np.array([len(e.actions) for e in self.episodes])
        cum = np.cumsum(sizes)
        flat = rng.integers(0, cum[-1], size=batch)
        ep_idx = np.searchsorted(cum, flat, side="right")
        row_idx = flat - np.concatenate([[0], cum[:-1]])[ep_idx]

        T = len(self.offsets)
        M = self.episodes[0].meas.shape[1]
        S = self.episodes[0].states.shape[1]
        out = {
            "state": np.empty((batch, S), np.float32),
            "meas": np.empty((batch, M), np.float32),
            "goal": np.empty((batch, M), np.float32),
            "action": np.empty((batch,), np.int32),
            "target": np.zeros((batch, T, M), np.float32),
            "target_mask": np.zeros((batch, T), np.float32),
        }
        for e in np.unique(ep_idx):
            sel = np.flatnonzero(ep_idx == e)
            ep = self.episodes[e]
            n = len(ep.actions)
            t = row_idx[sel]
            out["state"][sel] = ep.states[t]
            out["meas"][sel] = ep.meas[t]
            out["goal"][sel] = ep.goals[t]
            out["action"][sel] = ep.actions[t]
            future = t[:, None] + self.offsets[None, :]
            valid = future < n
            fut = np.minimum(future, n - 1)
            out["target"][sel] = ep.meas[fut] - ep.meas[t][:, None, :]
            out["target_mask"][sel] = valid.astype(np.float32)
        return out

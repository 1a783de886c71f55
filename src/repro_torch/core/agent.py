"""The MRSch scheduling agent (paper §III).

Wraps the DFP network with the vector state encoding, the Eq. (1) dynamic
goal vector, epsilon-greedy exploration, the episodic replay buffer and
Adam training on the future-measurement MSE.  Implements the simulator's
``SchedulingPolicy`` protocol (``select``, ε-greedy while ``training``),
the lockstep engine's batched stage (``select_batch``, ε-greedy and
recorded per environment slot while ``training``) and the device stages
of the ``Policy`` protocol
(``init_state``/``score_window``) that the device rollout engine scores
with.  ``save``/``load`` read and write the JAX package's ``.npz``
format, so a file saved by either package loads in the other.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import leaves, load_npz, save_npz
from ..nn.backend import resolve_backend
from ..nn.optim import adam_init, adam_update
from ..sim.cluster import ResourceSpec
from ..sim.simulator import SchedContext
from .dfp import (DFPConfig, DFPNetwork, action_values, greedy_actions_packed,
                  loss_fn)
from .encoding import (EncodingConfig, decision_row_dim, encode_decision_row,
                       encode_measurement, encode_state, pad_decision_rows)
from .goal import ctx_goal
from .replay import EpisodeRecorder, ReplayBuffer, VectorEpisodeRecorder


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; the CPU only when the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run on the CPU")
    return device


@dataclass(frozen=True)
class AgentConfig:
    window: int = 10
    offsets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    temporal_weights: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.5, 0.5, 1.0)
    lr: float = 1e-4
    batch_size: int = 64
    grad_steps_per_episode: int = 64
    buffer_rows: int = 200_000
    eps_start: float = 1.0
    eps_decay: float = 0.995          # paper §IV-C: alpha = 0.995
    eps_min: float = 0.02
    state_module: str = "mlp"         # "mlp" | "cnn" | "attention"
    backend: str = "kernel"           # "torch" | "kernel" (the CUDA kernels)
    state_hidden: Tuple[int, ...] = (4000, 1000)
    state_out: int = 512
    module_hidden: int = 128
    stream_hidden: int = 512
    # Queue-as-tokens knobs (state_module == "attention" only): the
    # encoder observes up to ``queue_cap`` waiting jobs instead of the
    # leading window of W.
    queue_cap: int = 128
    attn_dim: int = 64
    attn_heads: int = 4
    attn_layers: int = 2
    attn_mlp_mult: int = 2
    seed: int = 0
    grad_clip: float = 10.0


class MRSchAgent:
    """DFP-based multi-resource scheduling agent."""

    def __init__(self, resources: Sequence[ResourceSpec],
                 config: AgentConfig = AgentConfig(), *, device=None):
        self.resources = list(resources)
        self.config = config
        self.device = resolve_device(device)
        names = tuple(r.name for r in self.resources)
        caps = tuple(r.capacity for r in self.resources)
        attention = config.state_module == "attention"
        self.enc = EncodingConfig(window=config.window, resource_names=names,
                                  capacities=caps,
                                  state_module=config.state_module,
                                  queue_cap=(config.queue_cap if attention
                                             else 0))
        self.dfp = DFPConfig(
            state_dim=self.enc.state_dim,
            n_measurements=len(names),
            n_actions=config.window,
            offsets=config.offsets,
            temporal_weights=config.temporal_weights,
            state_module=config.state_module,
            backend=config.backend,
            state_hidden=config.state_hidden,
            state_out=config.state_out,
            module_hidden=config.module_hidden,
            stream_hidden=config.stream_hidden,
            attn_queue=config.queue_cap,
            attn_dim=config.attn_dim,
            attn_heads=config.attn_heads,
            attn_layers=config.attn_layers,
            attn_mlp_mult=config.attn_mlp_mult,
        )
        gen = torch.Generator().manual_seed(config.seed)
        self.net = DFPNetwork(self.dfp, generator=gen, device=self.device)
        self.opt_state = adam_init(self._params())
        self.replay = ReplayBuffer(config.offsets, config.buffer_rows)
        self.recorder = EpisodeRecorder()
        self.vec_recorder = VectorEpisodeRecorder()
        self.rng = np.random.default_rng(config.seed)
        self.epsilon = config.eps_start
        self.training = False
        self.losses: List[float] = []
        # The Eq. (1) goal of every decision, in order, on both selection
        # paths and in both modes (the reference's ``goal_log``).
        self.goal_log: List[np.ndarray] = []
        # Pre-clip global gradient norm, the mean over the latest burst.
        self.last_grad_norm: Optional[float] = None

    def _params(self) -> List[torch.Tensor]:
        return [p for _, p in leaves(self.net)]

    def set_backend(self, backend: str) -> None:
        """Switch the NN execution backend ("torch" | "kernel") in place;
        the weights are the same on both."""
        self.dfp = replace(self.dfp, backend=resolve_backend(backend))
        self.config = replace(self.config, backend=backend)

    # ------------------------------------------------------ Policy protocol
    # Device-side stages (repro_torch.core.policy_api): the device rollout
    # engine calls ``score_window`` on rows it builds on the card; the
    # host stages below (``select`` / ``select_batch``) are unchanged.
    requires_obs = True

    def init_state(self) -> DFPNetwork:
        """Policy state for the device rollout: the network."""
        return self.net

    def score_window(self, net: DFPNetwork, obs: torch.Tensor) -> torch.Tensor:
        """Action values from packed decision rows (reference:
        ``MRSchAgent.score_window``).

        ``obs`` rows follow ``encoding.encode_decision_row``; the valid
        mask is applied by the engine, not here.
        """
        sd, m = self.enc.state_dim, self.enc.n_resources
        return action_values(net, self.dfp, obs[:, :sd].contiguous(),
                             obs[:, sd:sd + m].contiguous(),
                             obs[:, sd + m:sd + 2 * m].contiguous())

    # ---------------------------------------------------------------- policy
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def select(self, ctx: SchedContext) -> int:
        """Greedy, or ε-greedy while ``training`` (one uniform draw per
        decision and one integer draw when exploring, from ``rng``), in
        which case the decision is recorded for the replay buffer."""
        state = encode_state(self.enc, ctx)
        meas = encode_measurement(self.enc, ctx)
        goal = ctx_goal(ctx, self.enc.resource_names)
        self.goal_log.append(goal)
        n_valid = min(len(ctx.window), self.config.window)
        if self.training and self.rng.uniform() < self.epsilon:
            action = int(self.rng.integers(0, n_valid))
        else:
            u = action_values(self.net, self.dfp, self._tensor(state)[None],
                              self._tensor(meas)[None],
                              self._tensor(goal)[None])
            u = u[0].cpu().numpy()
            u[n_valid:] = -np.inf
            action = int(np.argmax(u))
        if self.training:
            self.recorder.record(state, meas, goal, action)
        return action

    def select_batch(self, ctxs: Sequence[SchedContext],
                     slots: Optional[Sequence[int]] = None) -> np.ndarray:
        """Actions for N pending decisions with ONE forward.

        In evaluation mode the actions are greedy and ``slots`` is
        ignored.  In training mode ``slots`` (one environment id per
        context) is required: each row gets its own ε-greedy draw and its
        transition is recorded into that environment's accumulator
        (``vec_recorder``).  ``rng`` is consumed in row order — one
        uniform draw per decision, plus one integer draw when exploring —
        as ``select`` consumes it, so an N=1 batched rollout reproduces
        sequential training bit for bit from the same seed.  The forward
        runs over the exploiting rows only.
        """
        if self.training and slots is None:
            raise RuntimeError(
                "select_batch without env slots is evaluation-only: "
                "training interleaves N environments, so each context "
                "needs a slot id routing its transition to a per-env "
                "episode accumulator — pass slots=[...] (the vectorised "
                "trainer in repro_torch.core.train does this), or train "
                "with Simulator.run per trace")
        n = len(ctxs)
        sd, m, a = self.enc.state_dim, self.enc.n_resources, self.config.window
        feats = np.zeros((n, decision_row_dim(self.enc, a)), dtype=np.float32)
        for i, c in enumerate(ctxs):
            self.goal_log.append(
                encode_decision_row(self.enc, c, a, out=feats[i]))
        if not self.training:
            return self._greedy_rows(feats)
        acts = np.zeros(n, dtype=np.int32)
        explore = np.empty(n, dtype=bool)
        for i, c in enumerate(ctxs):
            explore[i] = self.rng.uniform() < self.epsilon
            if explore[i]:
                acts[i] = int(self.rng.integers(0, min(len(c.window), a)))
        exploit = np.flatnonzero(~explore)
        if exploit.size:
            acts[exploit] = self._greedy_rows(feats[exploit])
        for i, slot in enumerate(slots):
            self.vec_recorder.record(
                int(slot), feats[i, :sd].copy(), feats[i, sd:sd + m].copy(),
                feats[i, sd + m:sd + 2 * m].copy(), int(acts[i]))
        return acts

    def _greedy_rows(self, rows: np.ndarray) -> np.ndarray:
        """One forward over packed decision rows -> greedy actions.  Width
        is padded up to a power of two, as the JAX package pads it for its
        jit cache; padded rows are valid everywhere and their actions are
        discarded."""
        n = rows.shape[0]
        width = 1 << max(n - 1, 0).bit_length()
        packed = pad_decision_rows(rows, width, self.enc)
        acts = greedy_actions_packed(self.net, self.dfp, self._tensor(packed))
        return acts.cpu().numpy()[:n].astype(np.int32)

    # ---------------------------------------------------------------- train
    def begin_vector_episodes(self, n_envs: int) -> None:
        """Reset the per-environment accumulators for a batched rollout."""
        self.vec_recorder = VectorEpisodeRecorder(n_envs)

    def end_episode(self, slot: Optional[int] = None) -> Optional[float]:
        """Flush the recorded episode into the replay buffer; once the
        buffer holds a minibatch, run ``grad_steps_per_episode`` train
        steps and decay epsilon.  Returns the burst's mean loss, or None
        when no step ran.

        ``slot=None`` closes the sequential recorder (``select`` path);
        ``slot=i`` closes environment ``i``'s accumulator of a batched
        rollout, so a lane that finishes mid-round trains the network
        while the other lanes are still collecting.
        """
        ep = (self.recorder.finish() if slot is None
              else self.vec_recorder.finish(slot))
        if ep is not None:
            self.replay.add(ep)
        if not self.training or self.replay.rows < self.config.batch_size:
            return None
        mean_loss = self.train_steps(self.config.grad_steps_per_episode)
        if mean_loss is None:
            return None
        self.losses.append(mean_loss)
        self.epsilon = max(self.config.eps_min,
                           self.epsilon * self.config.eps_decay)
        return mean_loss

    def train_steps(self, steps: int) -> Optional[float]:
        """Run ``steps`` Adam steps on replay minibatches; returns the mean
        loss (None when the buffer cannot fill a minibatch) and sets
        ``last_grad_norm`` to the mean pre-clip gradient norm.

        All minibatches are sampled first, in the reference's order, and
        copied to the device together; losses and norms stay on the device
        until the burst ends, so a burst reads the host back once.
        """
        if self.replay.rows < self.config.batch_size or steps <= 0:
            return None
        samples = [self.replay.sample(self.rng, self.config.batch_size)
                   for _ in range(steps)]
        batches = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
                   .to(self.device) for k in samples[0]}
        params = self._params()
        losses, norms = [], []
        for i in range(steps):
            loss = loss_fn(self.net, self.dfp,
                           {k: v[i] for k, v in batches.items()})
            grads = torch.autograd.grad(loss, params)
            self.opt_state, gnorm = adam_update(
                grads, self.opt_state, params, lr=self.config.lr,
                grad_clip=self.config.grad_clip)
            losses.append(loss.detach())
            norms.append(gnorm)
        mean_loss, mean_norm = torch.stack(
            [torch.stack(losses).mean(), torch.stack(norms).mean()]).tolist()
        self.last_grad_norm = mean_norm
        return mean_loss

    # ---------------------------------------------------------------- io
    def save(self, path: str) -> None:
        save_npz(path, self.net, epsilon=self.epsilon)

    def load(self, path: str) -> None:
        """Restore ``save``d weights and epsilon (from either package),
        raising ``ValueError`` on a leaf count, shape or dtype mismatch (a
        checkpoint of the other state module differs in its leaf count);
        the Adam state starts afresh."""
        self.epsilon = load_npz(path, self.net)
        self.opt_state = adam_init(self._params())

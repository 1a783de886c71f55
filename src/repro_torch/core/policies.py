"""Comparison scheduling policies (paper §IV-D), the JAX package's
``repro/core/policies.py``.

* FCFS        — list-scheduling extension of first-come-first-serve to
                multi-resource; always selects the head of the window.
* GAOptimizer — multi-objective optimization over the window solved with a
                genetic algorithm (NSGA-II-style non-dominated sorting),
                after Fan et al. "Scheduling Beyond CPUs" [13]; numpy on
                the host, as in the reference.
* ScalarRL    — policy-gradient RL with a *fixed-weight* scalar reward
                (0.5 * util_A + 0.5 * util_B ...), the paper's single-
                objective RL strawman.  Its network runs as plain PyTorch
                ops (the reference's ``mlp_apply``), never the fused-MLP
                kernel.

All policies run under the same simulator machinery (window, reservation,
EASY backfilling), so differences come from the selection rule alone.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import leaves
from ..nn.backend import mlp_forward
from ..nn.modules import MLP
from ..nn.optim import AdamState, adam_init, adam_update
from ..sim.cluster import ResourceSpec
from ..sim.simulator import SchedContext
from .agent import resolve_device
from .encoding import EncodingConfig, encode_measurement, encode_state
from .policy_api import WindowPolicy


class FCFSPolicy(WindowPolicy):
    """Head-of-queue list scheduling.

    Expressed through the ``Policy`` protocol as a static slot
    preference over the window-valid mask: earlier window slots score
    higher, so the masked argmax always lands on the head.  ``select`` keeps the trivial host fast
    path (identical result, no tensor round trip per decision).
    """

    requires_obs = False      # scores need only the window-valid mask

    def select(self, ctx: SchedContext) -> int:
        return 0

    def score_window(self, policy_state, obs: torch.Tensor) -> torch.Tensor:
        return -torch.arange(obs.shape[-1], dtype=torch.float32,
                             device=obs.device).expand(obs.shape)


# --------------------------------------------------------------------- GA
@dataclass(frozen=True)
class GAConfig:
    population: int = 24
    generations: int = 20
    tournament: int = 3
    crossover_rate: float = 0.9
    mutation_rate: float = 0.25
    seed: int = 0


class GAOptimizer:
    """Window-limited multi-objective GA.

    At each scheduling pass it evolves permutations of the current window;
    fitness = per-resource utilization after greedily packing the
    permutation onto the free resources (immediate effect, as in the
    optimization literature).  Non-dominated sorting + crowding distance
    pick the survivor; the winning permutation is then replayed one
    selection at a time.

    Deliberately no ``select_batch``: the cached plan is keyed to ONE
    trace's clock and window, so sharing an instance across lockstep
    environments would cross-contaminate plans.  The vector engine runs
    GA through its sequential per-environment fallback with one instance
    per environment (``VectorSimulator.from_factory``).
    """

    # Host-only stages of the Policy protocol: the evolving plan cache
    # has no tensor form, so every engine must drive GA through its
    # sequential ``select`` stage (``policy_api.supports_device`` reports
    # False).
    init_state = None
    score_window = None

    def __init__(self, config: GAConfig = GAConfig()):
        self.config = config
        self.rng = np.random.default_rng(config.seed)
        self._plan: List[int] = []       # jids in planned order
        self._plan_key: Tuple = ()

    # --- fitness -----------------------------------------------------------
    def _pack_objectives(self, perm, window, free, caps) -> np.ndarray:
        used = {n: 0 for n in caps}
        avail = dict(free)
        for idx in perm:
            job = window[idx]
            if all(job.demands.get(n, 0) <= avail[n] for n in caps):
                for n in caps:
                    d = job.demands.get(n, 0)
                    avail[n] -= d
                    used[n] += d
        busy = {n: caps[n] - free[n] for n in caps}
        return np.array([(busy[n] + used[n]) / max(caps[n], 1) for n in caps])

    @staticmethod
    def _nondominated_rank(objs: np.ndarray) -> np.ndarray:
        n = len(objs)
        rank = np.zeros(n, int)
        for i in range(n):
            for k in range(n):
                if k == i:
                    continue
                if np.all(objs[k] >= objs[i]) and np.any(objs[k] > objs[i]):
                    rank[i] += 1           # i is dominated by k
        return rank

    def _evolve(self, window, free, caps) -> List[int]:
        cfg = self.config
        W = len(window)
        if W == 1:
            return [0]
        pop = [self.rng.permutation(W) for _ in range(cfg.population)]
        pop[0] = np.arange(W)              # seed with FCFS order
        for _ in range(cfg.generations):
            objs = np.stack([self._pack_objectives(p, window, free, caps)
                             for p in pop])
            rank = self._nondominated_rank(objs)
            # crowding proxy: sum of objectives breaks ties inside a front
            score = -rank + 1e-3 * objs.sum(1)
            order = np.argsort(-score)
            elites = [pop[i] for i in order[: cfg.population // 2]]
            children = []
            while len(children) < cfg.population - len(elites):
                a, b = (elites[self.rng.integers(len(elites))] for _ in "ab")
                child = self._ox(a, b) if self.rng.uniform() < cfg.crossover_rate \
                    else a.copy()
                if self.rng.uniform() < cfg.mutation_rate and W > 1:
                    i, k = self.rng.choice(W, 2, replace=False)
                    child[i], child[k] = child[k], child[i]
                children.append(child)
            pop = elites + children
        objs = np.stack([self._pack_objectives(p, window, free, caps)
                         for p in pop])
        rank = self._nondominated_rank(objs)
        best = np.argsort(rank - 1e-3 * objs.sum(1))[0]
        return list(pop[best])

    def _ox(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Order crossover for permutations."""
        n = len(a)
        i, k = sorted(self.rng.choice(n, 2, replace=False))
        child = -np.ones(n, int)
        child[i:k + 1] = a[i:k + 1]
        fill = [x for x in b if x not in child]
        ptr = 0
        for pos in range(n):
            if child[pos] < 0:
                child[pos] = fill[ptr]
                ptr += 1
        return child

    # --- policy ------------------------------------------------------------
    def select(self, ctx: SchedContext) -> int:
        key = (ctx.now, tuple(j.jid for j in ctx.window))
        jids = [j.jid for j in ctx.window]
        if self._plan_key != key or not any(j in jids for j in self._plan):
            caps = dict(ctx.cluster.capacities)
            free = dict(ctx.cluster.free)
            order = self._evolve(ctx.window, free, caps)
            self._plan = [ctx.window[i].jid for i in order]
        # Serve the next planned jid still present in the window.
        for jid in self._plan:
            if jid in jids:
                self._plan = self._plan[self._plan.index(jid) + 1:]
                self._plan_key = (ctx.now, tuple(jids))
                return jids.index(jid)
        return 0


# --------------------------------------------------------------------- RL
@dataclass(frozen=True)
class ScalarRLConfig:
    window: int = 10
    hidden: Tuple[int, ...] = (512, 128)
    lr: float = 3e-4
    gamma: float = 0.99
    weights: Optional[Tuple[float, ...]] = None     # default: uniform 1/R
    seed: int = 0
    entropy_coef: float = 1e-3


def _pg_step(net: MLP, opt_state: AdamState, batch, lr: float,
             entropy_coef: float) -> Tuple[AdamState, torch.Tensor]:
    """One REINFORCE step: the masked log-softmax (-1e9 on invalid slots),
    the taken actions' log-probabilities times the advantage ``ret -
    mean(ret)``, minus ``entropy_coef`` times the entropy over the valid
    slots; then Adam with the gradient clipped to a global norm of 10, in
    place on ``net``.  Returns the new Adam state and the loss."""
    params = [p for _, p in leaves(net)]
    mask = batch["mask"]
    logits = mlp_forward(net, batch["state"], backend="torch")
    logp = torch.log_softmax(torch.where(mask, logits, -1e9), dim=-1)
    taken = logp.gather(1, batch["action"][:, None].long())[:, 0]
    adv = batch["ret"] - batch["ret"].mean()
    pg = -(taken * adv).mean()
    ent = -(torch.exp(logp) * torch.where(mask, logp, 0.0)).sum(-1).mean()
    loss = pg - entropy_coef * ent
    grads = torch.autograd.grad(loss, params)
    opt_state, _ = adam_update(grads, opt_state, params, lr=lr,
                               grad_clip=10.0)
    return opt_state, loss.detach()


class ScalarRLPolicy(WindowPolicy):
    """REINFORCE over window slots with a fixed-weight scalar reward.

    Evaluation batching and the device stage both come from the
    ``Policy`` protocol: ``score_window`` is one logits forward over the
    state section, consumed by ``WindowPolicy.select_batch`` on the host
    and by the device rollout engine on its device.  Training stays on
    the sequential ``select`` path — the REINFORCE episode buffers assume
    one contiguous trajectory, and ``WindowPolicy`` enforces that by
    refusing batched selection while ``training`` is set.

    The network (``params``, an ``MLP`` from a ``torch.Generator`` seeded
    with ``config.seed``) lives on ``device``: the card unless
    ``device="cpu"`` is asked for.  Sampling draws from ``rng`` (numpy,
    seeded with ``config.seed``) as the reference does.
    """

    def __init__(self, resources: Sequence[ResourceSpec],
                 config: ScalarRLConfig = ScalarRLConfig(), *, device=None):
        self.resources = list(resources)
        self.config = config
        self.device = resolve_device(device)
        names = tuple(r.name for r in self.resources)
        caps = tuple(r.capacity for r in self.resources)
        self.enc = EncodingConfig(window=config.window, resource_names=names,
                                  capacities=caps)
        R = len(names)
        self.weights = np.asarray(config.weights if config.weights
                                  else [1.0 / R] * R)
        sizes = [self.enc.state_dim, *config.hidden, config.window]
        gen = torch.Generator().manual_seed(config.seed)
        self.params = MLP(sizes, generator=gen, device=self.device)
        self.opt_state = adam_init([p for _, p in leaves(self.params)])
        self.rng = np.random.default_rng(config.seed)
        self.training = False
        self._states: List[np.ndarray] = []
        self._actions: List[int] = []
        self._masks: List[np.ndarray] = []
        self._meas: List[np.ndarray] = []
        self.losses: List[float] = []

    def select(self, ctx: SchedContext) -> int:
        state = encode_state(self.enc, ctx)
        n_valid = min(len(ctx.window), self.config.window)
        mask = np.zeros(self.config.window, bool)
        mask[:n_valid] = True
        with torch.no_grad():
            logits = mlp_forward(
                self.params, torch.from_numpy(state).to(self.device),
                backend="torch").cpu().numpy()
        logits[~mask] = -1e9
        if self.training:
            z = logits - logits.max()
            probs = np.exp(z) / np.exp(z).sum()
            action = int(self.rng.choice(self.config.window, p=probs))
            self._states.append(state)
            self._actions.append(action)
            self._masks.append(mask)
            self._meas.append(encode_measurement(self.enc, ctx))
        else:
            action = int(np.argmax(logits))
        return action

    # ------------------------------------------------- Policy protocol
    def init_state(self) -> MLP:
        return self.params

    def score_window(self, policy_state: MLP, obs: torch.Tensor
                     ) -> torch.Tensor:
        """Logits from the state section of the packed row."""
        return mlp_forward(policy_state,
                           obs[..., : self.enc.state_dim].contiguous(),
                           backend="torch")

    def _encode_rows(self, ctxs: Sequence[SchedContext],
                     n_actions: int) -> np.ndarray:
        # Only the state section feeds the logits; skip the
        # measurement/goal encoding the full decision row would pay for.
        return np.stack([encode_state(self.enc, c) for c in ctxs])

    def episode_batch(self) -> Dict[str, np.ndarray]:
        """The recorded episode as the REINFORCE step's batch (numpy):
        states, actions, valid masks and the discounted returns of the
        fixed-weight scalar reward observed at the *next* decision.  The
        returns accumulate in float64, as the reference's do, and are cast
        to float32 at the end."""
        meas = np.stack(self._meas)                       # (n, R)
        scalar = meas @ self.weights
        rewards = np.append(scalar[1:], scalar[-1])
        rets = np.zeros_like(rewards)
        acc = 0.0
        for i in range(len(rewards) - 1, -1, -1):
            acc = rewards[i] + self.config.gamma * acc
            rets[i] = acc
        return {
            "state": np.stack(self._states),
            "action": np.asarray(self._actions, np.int64),
            "mask": np.stack(self._masks),
            "ret": rets.astype(np.float32),
        }

    def end_episode(self) -> Optional[float]:
        if not self.training or len(self._actions) < 2:
            self._states, self._actions, self._masks, self._meas = [], [], [], []
            return None
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in self.episode_batch().items()}
        self.opt_state, loss = _pg_step(
            self.params, self.opt_state, batch, self.config.lr,
            self.config.entropy_coef)
        self._states, self._actions, self._masks, self._meas = [], [], [], []
        loss = float(loss)
        self.losses.append(loss)
        return loss

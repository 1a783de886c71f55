"""Vector state encoding (paper §III-A) plus the queue-as-tokens layout.

Classic (``state_module`` "mlp" / "cnn") — each waiting job in the
window -> (R + 2) elements:
    [P_i1 .. P_iR,  walltime_estimate,  queued_time]
where P_ij is the requested fraction of resource j's capacity and the two
times are normalized by ``time_scale``.

Each resource *unit* -> 2 elements:
    [availability bit,  (estimated release time - now) if occupied else 0]

Concatenated into one fixed-size vector:
    dim = W*(R+2) + sum_r 2*capacity_r
which reproduces the paper's 11410 for (W=10, 4392 nodes, 1293 BB units).

Attention (``state_module`` "attention") — the window cap is removed:
the first ``queue_cap`` (Q >= W) waiting jobs each become one (R + 2)
token in queue order (the leading W are exactly the window), followed by
the queue length (at most Q) and a 2R cluster-context summary
[free_fraction_r, mean normalized time-to-free over busy units of r]:
    dim = Q*(R+2) + 1 + 2R
which ``repro_torch.nn.queue_encoder`` consumes.

The packed decision-row contract is ``[state | meas | goal | valid]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..sim.cluster import TTF_HORIZON, Cluster
from ..sim.job import Job
from ..sim.simulator import SchedContext
from .goal import ctx_goal

DAY = 86400.0

STATE_MODULES = ("mlp", "cnn", "attention")


@dataclass(frozen=True)
class EncodingConfig:
    window: int                      # W
    resource_names: Sequence[str]    # ordered resource list
    capacities: Sequence[int]        # units per resource
    time_scale: float = DAY          # normalizer for all time quantities
    state_module: str = "mlp"        # "mlp"/"cnn" share the classic layout;
    #                                  "attention" = queue-as-tokens layout
    queue_cap: int = 0               # Q, attention layout only (>= window)

    def __post_init__(self):
        if self.state_module not in STATE_MODULES:
            raise ValueError(f"unknown state_module "
                             f"{self.state_module!r}; expected one of "
                             f"{STATE_MODULES}")
        if (self.state_module == "attention"
                and self.queue_cap < max(int(self.window), 1)):
            raise ValueError(
                f"attention encoding needs queue_cap >= window, got "
                f"queue_cap={self.queue_cap} window={self.window} — the "
                "leading window tokens double as the action slots")

    @property
    def n_resources(self) -> int:
        return len(self.resource_names)

    @property
    def job_dim(self) -> int:
        return self.n_resources + 2

    @property
    def ctx_dim(self) -> int:
        """Attention layout: context-summary width (2 per resource)."""
        return 2 * self.n_resources

    @property
    def state_dim(self) -> int:
        if self.state_module == "attention":
            return self.queue_cap * self.job_dim + 1 + self.ctx_dim
        return self.window * self.job_dim + 2 * int(sum(self.capacities))


def _job_static_row(job: Job, key: tuple, caps: Sequence[float],
                    time_scale: float) -> np.ndarray:
    """[P_i1 .. P_iR, walltime_norm] for one window job, cached per job.

    Everything but the queued time is fixed for a given (resource order,
    capacities, time scale) — and this runs for every window slot on every
    scheduling decision, so the row is stashed on the job instance.
    """
    cached = job.__dict__.get("_enc_row")
    if cached is not None and cached[0] == key:
        return cached[1]
    names = key[0]
    row = np.empty(len(names) + 1, np.float32)
    for r, name in enumerate(names):
        row[r] = job.demands.get(name, 0) / caps[r]
    row[-1] = job.walltime / time_scale
    job.__dict__["_enc_row"] = (key, row)
    return row


def encode_state(cfg: EncodingConfig, ctx: SchedContext,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """Build the full state vector for one scheduling instance.

    The layout is fixed by ``cfg.capacities`` so one network can observe
    heterogeneous environments: a context whose cluster has fewer units
    than the reference (a scaled-down lane from
    ``repro_torch.workloads.sweep.build_train_mix``) fills only the leading unit slots of each resource section; the
    absent units read as unavailable (availability bit 0, time-to-free
    0).  Demand fractions are normalized
    by the context's own cluster capacity, so "half the machine" means the
    same thing in every lane.  ``out``, when given, must be a zeroed
    float32 buffer of ``cfg.state_dim`` (the batched agent writes rows of
    its packed decision buffer directly).
    """
    if out is None:
        out = np.zeros(cfg.state_dim, dtype=np.float32)
    # The cache key is identical for every decision on one cluster (caps
    # are fixed at construction), so stash it there: encoding runs on the
    # per-decision hot path.
    cached = ctx.cluster.__dict__.get("_enc_key")
    if cached is not None and cached[0] is cfg:
        key, caps_t = cached[1], cached[2]
        names = key[0]
    else:
        caps = ctx.cluster.capacities
        names = tuple(cfg.resource_names)
        caps_t = tuple(float(max(int(caps.get(n, c)), 1))
                       for n, c in zip(names, cfg.capacities))
        key = (names, caps_t, cfg.time_scale)
        ctx.cluster.__dict__["_enc_key"] = (cfg, key, caps_t)
    R = cfg.n_resources
    if cfg.state_module == "attention":
        # --- queue-as-tokens layout: [Q*(R+2) | queue_len | 2R context]
        now = ctx.now
        queue = ctx.queue if ctx.queue is not None else ctx.window
        Q = cfg.queue_cap
        for slot, job in enumerate(queue[:Q]):
            base = slot * cfg.job_dim
            out[base: base + R + 1] = _job_static_row(job, key, caps_t,
                                                      cfg.time_scale)
            out[base + R + 1] = (now - job.submit) / cfg.time_scale
        out[Q * cfg.job_dim] = min(len(queue), Q)
        offset = Q * cfg.job_dim + 1
        for r, name in enumerate(cfg.resource_names):
            rel = ctx.cluster.release[name]
            busy = rel > 0.0
            nb = int(busy.sum())
            out[offset] = 1.0 - nb / caps_t[r]               # free fraction
            if nb:
                # Upper clip keeps permanently drained units (release =
                # +inf phantom reservations) from leaking inf features.
                ttf = np.clip(rel[busy] - now, 0.0, TTF_HORIZON).sum() / nb
                out[offset + 1] = ttf / cfg.time_scale       # mean time-to-free
            offset += 2
        return out
    # --- window jobs
    now = ctx.now
    for slot, job in enumerate(ctx.window[: cfg.window]):
        base = slot * cfg.job_dim
        out[base: base + R + 1] = _job_static_row(job, key, caps_t,
                                                  cfg.time_scale)
        out[base + R + 1] = (now - job.submit) / cfg.time_scale
    # --- resource units, written straight into the output buffer (this is
    # the decision hot path: one encode per policy decision)
    offset = cfg.window * cfg.job_dim
    for r, name in enumerate(cfg.resource_names):
        section = int(cfg.capacities[r])
        rel = ctx.cluster.release[name]   # estimated release time, 0 == free
        k = min(rel.shape[0], section)
        rel = rel[:k]
        busy = rel > 0.0
        out[offset: offset + k] = ~busy                          # avail bit
        ttf = out[offset + section: offset + section + k]
        np.subtract(rel, ctx.now, out=ttf, where=busy)           # time-to-free
        np.maximum(ttf, 0.0, out=ttf)
        np.minimum(ttf, TTF_HORIZON, out=ttf)   # drained units release at +inf
        ttf /= cfg.time_scale
        offset += 2 * section
    return out


def encode_measurement(cfg: EncodingConfig, ctx: SchedContext) -> np.ndarray:
    """Measurement vector = instantaneous utilization per resource (§III-A)."""
    util = ctx.cluster.utilization()
    return util.astype(np.float32)


# ------------------------------------------------------------- packed rows
# One decision = one packed row [state | meas | goal | valid-mask]; the
# batched agent path (MRSchAgent.select_batch / _greedy_rows) and the
# decision service (repro_torch.serve) MUST agree on this layout byte for byte
# — bit-identical serving depends on it — so it is defined only here.

def decision_row_dim(cfg: EncodingConfig, n_actions: int) -> int:
    return cfg.state_dim + 2 * cfg.n_resources + n_actions


def encode_decision_row(cfg: EncodingConfig, ctx: SchedContext,
                        n_actions: int, out: np.ndarray,
                        goal: Optional[np.ndarray] = None) -> np.ndarray:
    """Fill one packed decision row in place; returns the goal used.

    ``out`` must be a zeroed float32 buffer of ``decision_row_dim``.
    ``goal`` overrides the Eq. (1) context goal (per-request objective
    steering in the serving layer)."""
    sd, m = cfg.state_dim, cfg.n_resources
    encode_state(cfg, ctx, out=out[:sd])
    out[sd:sd + m] = encode_measurement(cfg, ctx)
    if goal is None:
        goal = ctx_goal(ctx, cfg.resource_names)
    out[sd + m:sd + 2 * m] = goal
    out[sd + 2 * m:sd + 2 * m + min(len(ctx.window), n_actions)] = 1.0
    return goal


def pad_decision_rows(rows: np.ndarray, width: int,
                      cfg: EncodingConfig) -> np.ndarray:
    """Pad packed rows up to ``width``: padded rows are valid everywhere
    and their actions are discarded by the caller."""
    n = rows.shape[0]
    if width == n:
        return rows
    packed = np.zeros((width, rows.shape[1]), dtype=np.float32)
    packed[:n] = rows
    packed[n:, cfg.state_dim + 2 * cfg.n_resources:] = 1.0
    return packed


def encoding_for(cluster: Cluster, window: int,
                 time_scale: float = DAY, state_module: str = "mlp",
                 queue_cap: int = 0) -> EncodingConfig:
    """The encoding of ``cluster``'s resources and capacities."""
    return EncodingConfig(
        window=window,
        resource_names=tuple(cluster.names),
        capacities=tuple(cluster.capacities[n] for n in cluster.names),
        time_scale=time_scale,
        state_module=state_module,
        queue_cap=queue_cap,
    )

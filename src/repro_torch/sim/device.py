"""Device-resident rollout engine: N trace simulations stepped together on
the card (the JAX package's ``repro/sim/device.py``).

``DeviceSimulator`` runs N independent trace simulations over tensors on
one device.  Each scheduling round advances lifecycle events (one
coalesced-timestamp pop per environment), builds the front of the
deciding round in one call (``repro_torch.kernels.window_pack``'s
``pack_decision_rows``, one launch on the card: the queued mask, the free
units, the first W waiting jobs and the packed decision rows), scores the
rows with the policy's ``score_window`` stage
(``repro_torch.core.policy_api``), and applies the
selected action — immediate start with first-free unit allocation, or a
reservation with EASY-backfill shadow accounting.  State never leaves the
device between rounds; the host packs the traces up front and summarizes
metrics at the end.

The reference is one jitted program; its control flow becomes Python
here, and each branch on device data costs one host sync, counted in
``DeviceStats.host_syncs``:

* ``lax.scan`` over rounds -> a Python loop over rounds; one sync per
  round reads "any environment needs a decision" and "every environment
  is done" together, and the loop stops once every environment is done
  (the remaining rounds of the reference's scan are idle, so the outputs
  are the same);
* ``lax.cond`` on "any environment needs a decision" -> that same sync;
* the backfill's ``lax.while_loop`` -> one sync per loop test;
* ``lax.cond`` around backfill unit assignment -> no sync: the loop ran
  at least once exactly when some environment backfills.

The backfill's unit assignment is O(N * units) here: each free unit of
rank k goes to the started job j with ``cum[j-1] < k <= cum[j]`` of the
cumulative demands (``torch.searchsorted``), the units the reference's
dense (N, units, J) one-hot assigns.

State layout (leading axis = environment), as in the reference:

* job tensors ``(N, J)`` — submit/runtime/walltime (f32, padded jobs
  carry ``submit = +inf`` so they never arrive) and demands ``(N, J, R)``
  (f32 unit counts; exact below 2**24); dependency indices ``(N, J, P)``
  (packed job index, -1 = none), think times ``(N, J)`` and failure
  points ``(N, J, A)`` (+inf padded);
* lifecycle state ``(N, J)`` — ``ready``/``started``/``finished``/
  ``failed`` masks, ``requeues``/``cur_fail`` attempt state,
  ``first_start_j``/``failed_work`` accounting; the waiting queue in
  (original submit, jid) order is exactly "ready and in no other live
  state, in ascending job index", which is what the window pack assumes;
* per-unit cluster state ``(N, U)`` with ``U = sum(capacities)`` —
  ``release`` (estimated release time, 0 = free; drained units carry
  their restore time) and ``owner`` (job index, -1 free, -2
  phantom/drained), in fixed per-resource segments;
* per-env ``now``, ``in_pass``, ``done``, ``decisions``.

Times are float32 on the device, as in the reference, so an N=1 rollout
reproduces the sequential engine's schedule with metrics equal to
float32 precision.  Decision rows follow the policy's state module: the
classic layout ("mlp" and "cnn") or the "attention" queue-as-tokens
layout, whose first ``queue_cap`` waiting jobs come from the same window
pack.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.window_pack import DecisionRowSpec, pack_decision_rows
from ..obs.profiling import SpanRecorder, annotate
from ..obs.trace import Tracer
from .cluster import Cluster, ResourceSpec
from .job import Job
from .lifecycle import (FAILED, FINISHED, FaultSchedule,
                        device_apply_drains, device_apply_ends,
                        device_apply_restores, device_attempt,
                        device_next_event, device_queued, device_ready,
                        resolve_faults)
from .metrics import MetricsAccumulator
from .simulator import SimConfig, SimResult


class DeviceFaults(NamedTuple):
    """Packed fault schedules, one row per environment (D = max drains).

    Unused drain slots carry ``drain_t = +inf`` so they never fire;
    ``unit_seg``/``unit_local`` map every packed unit to its (resource
    segment, within-segment index) so a drain's "first k units of
    resource r" range is one vectorized compare."""
    drain_t: torch.Tensor        # (N, D) f32, +inf = unused slot
    restore_t: torch.Tensor      # (N, D) f32, +inf = permanent drain
    drain_res: torch.Tensor      # (N, D) i32 resource segment index
    drain_units: torch.Tensor    # (N, D) i32 leading units drained
    unit_seg: torch.Tensor       # (U,)  i32 segment of each packed unit
    unit_local: torch.Tensor     # (U,)  i32 index within the segment
    max_requeues: torch.Tensor   # (N, 1) i32 requeue bound per env


@dataclass(frozen=True)
class DeviceLayout:
    """Static shape/semantic configuration of one rollout."""
    names: Tuple[str, ...]
    caps: Tuple[int, ...]            # actual cluster capacities
    enc_caps: Tuple[int, ...]        # encoding section sizes (reference caps)
    window: int
    n_envs: int
    n_jobs: int                      # J, padded job axis
    rounds: int                      # T, round budget
    backfill: bool
    requires_obs: bool
    time_scale: float
    state_module: str = "mlp"        # mirrors EncodingConfig.state_module
    queue_cap: int = 0               # Q, attention layout only

    @property
    def n_resources(self) -> int:
        return len(self.names)

    @property
    def node_idx(self) -> int:
        """Resource anchoring the failed-work metric (JobLifecycle.primary)."""
        return self.names.index("node") if "node" in self.names else 0

    @property
    def segments(self) -> Tuple[Tuple[int, int], ...]:
        """(offset, capacity) per resource into the packed unit axis."""
        segs, off = [], 0
        for c in self.caps:
            segs.append((off, c))
            off += c
        return tuple(segs)

    @property
    def n_units(self) -> int:
        return int(sum(self.caps))

    @property
    def state_dim(self) -> int:
        if self.state_module == "attention":
            return (self.queue_cap * (self.n_resources + 2) + 1
                    + 2 * self.n_resources)
        return self.window * (self.n_resources + 2) + 2 * int(sum(self.enc_caps))


@dataclass
class DeviceStats:
    """Counts of one rollout (the reference's four, plus the host syncs
    that this engine's Python round loop pays)."""
    rounds: int = 0                  # rounds with at least one decision
    decisions: int = 0
    policy_calls: int = 0            # one batched score per active round
    max_batch: int = 0
    rounds_run: int = 0              # rounds the loop ran before all were done
    host_syncs: int = 0              # device-to-host reads inside the loop

    def as_dict(self) -> dict:
        return {"rounds": self.rounds, "decisions": self.decisions,
                "policy_calls": self.policy_calls,
                "max_batch": self.max_batch, "rounds_run": self.rounds_run,
                "host_syncs": self.host_syncs}


@dataclass
class DeviceRollout:
    """One device rollout: per-env results plus the decision trace.

    ``results`` materializes lazily on first access: rebuilding per-job
    Python objects for every environment is host work that
    collection-mode consumers (which ingest the packed decision rows, not
    ``SimResult``s) should not pay.
    """
    actions: np.ndarray              # (T, N) int32, -1 where no decision
    decided: np.ndarray              # (T, N) bool
    stats: DeviceStats
    obs: Optional[np.ndarray] = None  # (T, N, row_dim) packed decision rows
    trace: Optional[Dict[str, np.ndarray]] = None  # rollout(trace=True):
    #   per-round state deltas + decision extras, decoded into mrsch.trace
    #   events by DeviceSimulator.emit_trace
    _build: Optional[Callable[[], List[SimResult]]] = field(
        default=None, repr=False)
    _cache: Optional[List[SimResult]] = field(default=None, repr=False)

    @property
    def results(self) -> List[SimResult]:
        """Per-env ``SimResult``s in jobset order (built on demand)."""
        if self._cache is None:
            self._cache = self._build()
        return self._cache

    def transitions(self):
        """Yield (round, env, obs_row, action) for every decision taken,
        in round order (reference: ``DeviceRollout.transitions``)."""
        if self.obs is None:
            raise ValueError("rollout was not collected; pass collect=True")
        for t in range(self.decided.shape[0]):
            for i in np.flatnonzero(self.decided[t]):
                yield t, int(i), self.obs[t, i], int(self.actions[t, i])


class _SyncCounter:
    """Every device-to-host read inside the round loop goes through here;
    with a span recorder, each read is a span its caller names."""

    def __init__(self, spans: Optional[SpanRecorder] = None) -> None:
        self.n = 0
        self.spans = spans

    def __call__(self, span: str, *flags: torch.Tensor) -> list:
        """A read inside the open phase, recorded as its child ``span``."""
        self.n += 1
        if self.spans is None:
            return torch.stack(flags).tolist()
        self.spans.open(span)
        out = torch.stack(flags).tolist()
        self.spans.close()
        return out

    def phase(self, span: str, *flags: torch.Tensor) -> list:
        """A read that is a phase of its own, ``span``, which the next
        phase the caller opens ends."""
        self.n += 1
        if self.spans is not None:
            self.spans.next(span)
        return torch.stack(flags).tolist()


# ===================================================================== rounds
def _advance_events(layout: DeviceLayout, arrays, faults: DeviceFaults, st):
    """Batched event step: pop and apply ONE coalesced timestamp per env
    not inside a scheduling pass (reference: ``_advance_events``).

    Events at one timestamp apply in the host engines' kind order:
    attempt ends (clean finish or failure-point kill), then queue
    entries (implicit — the queued mask is derived from READY times),
    then drains, then restores."""
    P = arrays["deps_idx"].shape[2]
    A = arrays["fail_times"].shape[2]
    D = faults.drain_t.shape[1]
    s = dict(st)
    # A pass over an empty queue ends silently (Simulator.next_decision).
    queued_any = device_queued(s["ready"], s["now"], s["started"],
                               s["finished"], s["failed"]).any(dim=1)
    in_pass = s["in_pass"] & queued_any
    adv = ~in_pass & ~s["done"]
    t = device_next_event(s["now"], s["ready"], s["end"], s["started"],
                          s["finished"], s["failed"],
                          faults if D else None, s)
    no_ev = ~torch.isfinite(t)
    s["done"] = s["done"] | (adv & no_ev)
    act = adv & ~no_ev
    s["now"] = torch.where(act, t, s["now"])
    s = device_apply_ends(t, act, arrays["demands"], layout.node_idx,
                          faults.max_requeues, s, has_kills=(A > 0 or D > 0))
    if D:
        s = device_apply_drains(t, act, faults, arrays["demands"],
                                layout.node_idx, s)
        s = device_apply_restores(t, act, faults, s)
    if P:
        # Finishes may have released dependents: recompute READY times.
        s["ready"] = device_ready(arrays["submit"], arrays["deps_idx"],
                                  arrays["think"], s["end"], s["finished"])
    s["in_pass"] = in_pass | act
    return s


def _alloc_first_free(layout: DeviceLayout, release, owner, env_mask,
                      job_idx, demand, est):
    """Allocate ``demand`` (N, R) lowest-index free units for ``job_idx``
    in every env of ``env_mask`` (reference: ``_alloc_first_free``)."""
    rel_cols, own_cols = [], []
    for r, (off, cap) in enumerate(layout.segments):
        seg = release[:, off:off + cap]
        freemask = seg == 0.0
        rank = torch.cumsum(freemask.float(), dim=1)
        take = (freemask & (rank <= demand[:, r:r + 1])
                & env_mask[:, None])
        rel_cols.append(torch.where(take, est[:, None], seg))
        own_cols.append(torch.where(take, job_idx[:, None],
                                    owner[:, off:off + cap]))
    return torch.cat(rel_cols, dim=1), torch.cat(own_cols, dim=1)


def _earliest_fit(layout: DeviceLayout, release, free, demand, now):
    """Per-env earliest time ``demand`` fits assuming estimated releases
    (reference: ``_earliest_fit``): the need-th smallest release per
    resource (free units sort first as 0.0), max over resources.
    Permanently drained units carry ``release = +inf``, sort last, and
    never count toward a future fit."""
    t_res = now
    for r, (off, cap) in enumerate(layout.segments):
        seg_sorted = torch.sort(release[:, off:off + cap], dim=1).values
        need = demand[:, r]
        kth_idx = (need.to(torch.int64) - 1).clamp(0, cap - 1)
        kth = torch.gather(seg_sorted, 1, kth_idx[:, None])[:, 0]
        t_r = torch.where(need <= free[:, r], now,
                          torch.where(need <= float(cap), kth, torch.inf))
        t_res = torch.maximum(t_res, t_r)
    return t_res


def _easy_backfill(layout: DeviceLayout, arrays, st, free, need, waiting,
                   j_star, d_star, dur_all, will_fail_all, sync):
    """EASY backfill for envs whose selection did not fit (reference:
    ``_easy_backfill``): reservation at the earliest fit time, shadow
    accounting in queue order, then one batched first-fit unit assignment
    for every job that may jump ahead.  ``dur_all``/``will_fail_all``
    describe each job's NEXT attempt (``lifecycle.device_attempt``)."""
    J = layout.n_jobs
    demands = arrays["demands"]                                  # (N, J, R)
    now = st["now"]
    t_res = _earliest_fit(layout, st["release"], free, d_star, now)
    do_bf = need & torch.isfinite(t_res)
    # Shadow: free units at t_res (estimated releases) minus the
    # reservation's demand, per resource.
    shadow = torch.stack(
        [(st["release"][:, off:off + cap] <= t_res[:, None]).sum(dim=1)
         for off, cap in layout.segments], dim=1).float() - d_star

    ends_before_all = arrays["walltime"] + now[:, None] <= t_res[:, None]
    jidx = torch.arange(J, device=now.device)
    cand = (do_bf[:, None] & (waiting > 0.5)
            & (jidx[None, :] != j_star[:, None]))                # (N, J)

    def fitting(free_c, shadow_c, go):
        fits_now = cand & ~go & (demands <= free_c[:, None, :]).all(dim=2)
        shadow_ok = (demands <= shadow_c[:, None, :]).all(dim=2)
        return fits_now & (ends_before_all | shadow_ok)

    # Walking the queue in order debiting as we go equals repeatedly
    # starting the FIRST still-fitting candidate.  Each iteration accepts
    # a whole PREFIX of the fitting candidates: a candidate is accepted
    # when the cumulative demand of accepted candidates up to and
    # including it still fits (free and shadow), and the first cumulative
    # failure blocks the rest of the queue until the next iteration
    # re-evaluates them against the debited carry.
    free_c, shadow_c = free, shadow
    go = torch.zeros_like(cand)
    ok = fitting(free_c, shadow_c, go)
    iterations = 0
    while sync("sync.backfill", ok.any())[0]:
        iterations += 1
        debit = ok & ~ends_before_all
        cum = torch.cumsum(ok[..., None] * demands, dim=1)
        free_ok = (cum <= free_c[:, None, :]).all(dim=2)
        cums = torch.cumsum(debit[..., None] * demands, dim=1)
        shadow_fit = (cums <= shadow_c[:, None, :]).all(dim=2)
        passes = free_ok & (ends_before_all | shadow_fit)
        fail = ok & ~passes
        accept = ok & passes & (torch.cumsum(fail.to(torch.int32), dim=1)
                                == 0)
        free_c = free_c - (accept[..., None] * demands).sum(dim=1)
        shadow_c = shadow_c - ((accept & ~ends_before_all)[..., None]
                               * demands).sum(dim=1)
        go = go | accept
        ok = fitting(free_c, shadow_c, go)
    if iterations == 0:
        # Nothing started (the loop accepts at least one candidate per
        # iteration): the reference's lax.cond skips unit assignment.
        return st
    bf_start = go

    # Unit assignment, one pass per resource: job j takes the free units
    # whose free-rank k falls in its cumulative-demand span, i.e. the j
    # with cum[j-1] < k <= cum[j] — identical to allocating each job
    # first-fit in queue order.
    est_all = now[:, None] + arrays["walltime"]                  # (N, J)
    release, owner = st["release"], st["owner"]
    rel_cols, own_cols = [], []
    for r, (off, cap) in enumerate(layout.segments):
        seg = release[:, off:off + cap]
        freemask = seg == 0.0
        k = torch.cumsum(freemask.float(), dim=1)                # (N, cap)
        cum = torch.cumsum(demands[:, :, r] * bf_start, dim=1)   # (N, J)
        j_of = torch.searchsorted(cum, k).clamp_max(J - 1)       # (N, cap)
        any_assign = freemask & (k <= cum[:, -1:])
        rel_cols.append(torch.where(any_assign,
                                    torch.gather(est_all, 1, j_of), seg))
        own_cols.append(torch.where(any_assign, j_of.to(owner.dtype),
                                    owner[:, off:off + cap]))
    out = dict(st)
    out["release"] = torch.cat(rel_cols, dim=1)
    out["owner"] = torch.cat(own_cols, dim=1)
    out["started"] = st["started"] | bf_start
    out["start"] = torch.where(bf_start, now[:, None], st["start"])
    out["end"] = torch.where(bf_start, now[:, None] + dur_all, st["end"])
    out["est_end"] = torch.where(bf_start, est_all, st["est_end"])
    out["first_start_j"] = torch.where(bf_start & (st["first_start_j"] < 0),
                                       now[:, None], st["first_start_j"])
    any_bf = bf_start.any(dim=1)
    out["first_start"] = torch.where(
        any_bf, torch.minimum(st["first_start"], now), st["first_start"])
    if will_fail_all is not None:
        out["cur_fail"] = torch.where(bf_start, will_fail_all, st["cur_fail"])
    return out


def _row_spec(layout: DeviceLayout, has_drains: bool) -> DecisionRowSpec:
    """What the front of every deciding round computes in this rollout.
    The attention module observes the first queue_cap waiting jobs; one
    pack covers both the Q-token state and (its leading W slots) the
    action window.  Every other state module ("mlp", "cnn") reads the
    classic rows, as the reference treats every module but "attention"."""
    attention = layout.state_module == "attention"
    mode = ("mask" if not layout.requires_obs
            else "attention" if attention else "mlp")
    return DecisionRowSpec(
        mode=mode, window=layout.window,
        k=layout.queue_cap if attention else layout.window,
        segments=layout.segments, enc_caps=layout.enc_caps,
        time_scale=layout.time_scale, has_drains=has_drains)


def _device_rollout(layout: DeviceLayout, score_fn, policy_state,
                    explore: bool, eps: float, gen, collect: bool,
                    trace: bool, arrays, faults: DeviceFaults,
                    sync: _SyncCounter, spans: Optional[SpanRecorder]):
    """The whole N-env rollout (reference: ``_device_rollout``).

    Returns a dict of device tensors: final per-job/per-env state, the
    (T, N) actions and decided masks, the decision rows of the rounds that
    decided (``collect``), and the per-round lifecycle deltas (``trace``),
    which ``DeviceSimulator.emit_trace`` decodes into the
    ``mrsch.trace/v1`` event stream.  With ``spans``, each round is a
    ``round`` span covered by its phases: ``advance``, ``sync.gate``, and
    in a deciding round ``front``, ``forward``, ``select`` and
    ``backfill``; then ``record``."""
    N, J, R, W, T = (layout.n_envs, layout.n_jobs, layout.n_resources,
                     layout.window, layout.rounds)
    A = arrays["fail_times"].shape[2]
    D = faults.drain_t.shape[1]
    has_drains = D > 0
    dev = arrays["submit"].device
    jidx = torch.arange(J, device=dev)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    falses = full((N, J), False, torch.bool)
    end0 = full((N, J), torch.inf, torch.float32)
    now0 = full((N,), 0.0, torch.float32)
    ready0 = device_ready(arrays["submit"], arrays["deps_idx"],
                          arrays["think"], end0, falses)
    # Jobs ready at t=0 are queued before any event can fire, so their
    # scheduling pass is seeded here — the host's t=0 submit pop.
    st = {
        "now": now0,
        "ready": ready0,
        "started": falses,
        "finished": falses,
        "failed": falses,
        "start": full((N, J), -1.0, torch.float32),
        "end": end0,
        "est_end": full((N, J), 0.0, torch.float32),
        "first_start_j": full((N, J), -1.0, torch.float32),
        "requeues": full((N, J), 0, torch.int32),
        "cur_fail": falses,
        "failed_work": full((N, J), 0.0, torch.float32),
        "failed_area": full((N, R), 0.0, torch.float32),
        "release": full((N, layout.n_units), 0.0, torch.float32),
        "owner": full((N, layout.n_units), -1, torch.int32),
        "drain_done": full((N, D), False, torch.bool),
        "restore_done": full((N, D), False, torch.bool),
        "in_pass": device_queued(ready0, now0, falses, falses,
                                 falses).any(dim=1),
        "done": full((N,), False, torch.bool),
        "decisions": full((N,), 0, torch.int32),
        "truncated": full((N,), 0, torch.int32),
        "first_start": full((N,), torch.inf, torch.float32),
    }
    # Constant per rollout: keep the concat out of the per-round body.
    feats = torch.cat([arrays["static_feats"],
                       arrays["submit_feat"][..., None]], dim=-1)

    spec = _row_spec(layout, has_drains)

    def decide(s):
        now = s["now"]
        if spans is not None:
            spans.next("front")
        # One launch on the card: queued mask, free counts, pack, rows.
        waiting, n_waiting, free, pk_idx, pk_valid, obs = pack_decision_rows(
            spec, ready=s["ready"], now=now, started=s["started"],
            finished=s["finished"], failed=s["failed"], release=s["release"],
            est_end=s["est_end"], owner=s["owner"] if has_drains else None,
            feats=feats, walltime=arrays["walltime"],
            demands=arrays["demands"], caps_f=arrays["caps_f"])
        need = s["in_pass"] & (n_waiting > 0) & ~s["done"]
        win_idx, win_valid = pk_idx[:, :W], pk_valid[:, :W]
        # Jobs a host Simulator would drop from the observable window this
        # decision (ScheduleMetrics.truncated_jobs; the attention module
        # still counts overflow past W, so both modules report the same
        # queue pressure).
        overflow = (n_waiting - float(W)).clamp_min(0.0).to(torch.int32)
        s = {**s, "truncated": s["truncated"] + need * overflow}
        if spans is not None:
            spans.next("forward")
        scores = score_fn(policy_state, obs)[:, :W]
        if spans is not None:
            spans.next("select")
        masked = torch.where(win_valid, scores, -torch.inf)
        a = torch.argmax(masked, dim=1)
        if explore:
            n_valid = win_valid.sum(dim=1).float()
            u_roll = torch.rand(N, generator=gen, device=dev)
            u_slot = torch.rand(N, generator=gen, device=dev)
            a_rand = torch.floor(u_slot * n_valid.clamp_min(1.0)).long()
            a = torch.where(u_roll < eps, a_rand, a)
        j_star = torch.gather(win_idx, 1, a[:, None])[:, 0].long()
        d_star = torch.gather(arrays["demands"], 1,
                              j_star[:, None, None].expand(N, 1, R))[:, 0]
        fits = (d_star <= free).all(dim=1)
        start_env = need & fits
        reserve_env = need & ~fits
        # --- immediate start (scheduling pass continues).  The attempt's
        # actual duration is its failure point when the attempt is doomed;
        # the unit-release ESTIMATE still uses the walltime.
        if A:
            dur_all, will_fail_all = device_attempt(
                arrays["fail_times"], s["requeues"], arrays["runtime"])
        else:
            dur_all, will_fail_all = arrays["runtime"], None
        wall_star = torch.gather(arrays["walltime"], 1, j_star[:, None])[:, 0]
        run_star = torch.gather(dur_all, 1, j_star[:, None])[:, 0]
        est = now + wall_star
        release, owner = _alloc_first_free(
            layout, s["release"], s["owner"], start_env,
            j_star.to(torch.int32), d_star, est)
        sel = (jidx[None, :] == j_star[:, None]) & start_env[:, None]
        s = {**s, "release": release, "owner": owner,
             "started": s["started"] | sel,
             "start": torch.where(sel, now[:, None], s["start"]),
             "end": torch.where(sel, (now + run_star)[:, None], s["end"]),
             "est_end": torch.where(sel, est[:, None], s["est_end"]),
             "first_start_j": torch.where(sel & (s["first_start_j"] < 0),
                                          now[:, None], s["first_start_j"]),
             "decisions": s["decisions"] + need.to(torch.int32),
             "first_start": torch.where(
                 start_env, torch.minimum(s["first_start"], now),
                 s["first_start"])}
        if A:
            wf_star = torch.gather(will_fail_all, 1, j_star[:, None])[:, 0]
            s["cur_fail"] = torch.where(sel, wf_star[:, None], s["cur_fail"])
        # --- reservation + EASY backfill (scheduling pass ends).
        if layout.backfill:
            if spans is not None:
                spans.next("backfill")
            s = _easy_backfill(layout, arrays, s, free, reserve_env, waiting,
                               j_star, d_star, dur_all, will_fail_all, sync)
        s = {**s, "in_pass": s["in_pass"] & ~reserve_env}
        return s, torch.where(need, a, -1), need, obs, (j_star, fits,
                                                        n_waiting)

    actions = full((T, N), -1, torch.int32)
    decided = full((T, N), False, torch.bool)
    obs_rows: List[Tuple[int, torch.Tensor]] = []
    tr = None
    if trace:
        tr = {"now": full((T, N), 0.0, torch.float32),
              "finish_d": full((T, N, J), False, torch.bool),
              "fail_d": full((T, N, J), False, torch.bool),
              "requeue_d": full((T, N, J), False, torch.bool),
              "start_d": full((T, N, J), False, torch.bool),
              "j_star": full((T, N), 0, torch.int32),
              "fit": full((T, N), False, torch.bool),
              "qlen": full((T, N), 0, torch.int32)}
        if D:
            tr["drain_d"] = full((T, N, D), False, torch.bool)
            tr["restore_d"] = full((T, N, D), False, torch.bool)

    rounds_run = 0
    for t in range(T):
        if spans is not None:
            spans.round = t
            spans.open("round", "advance")
        # Two-stage snapshots (pre-advance, post-advance): the deltas
        # distinguish advance-phase transitions (finish / fail / requeue
        # / drain / restore) from decide-phase starts.
        s_pre = st
        st = _advance_events(layout, arrays, faults, st)
        s_adv = st
        qa = device_queued(st["ready"], st["now"], st["started"],
                           st["finished"], st["failed"]).any(dim=1)
        any_need, all_done = sync.phase(
            "sync.gate", (st["in_pass"] & ~st["done"] & qa).any(),
            st["done"].all())
        rounds_run = t + 1
        if any_need:
            st, a_out, need, obs, dec = decide(st)
            if spans is not None:
                spans.next("record")
            actions[t] = a_out.to(torch.int32)
            decided[t] = need
            if collect:
                obs_rows.append((t, obs))
        elif spans is not None:
            spans.next("record")
        if trace:
            tr["now"][t] = s_adv["now"]
            tr["finish_d"][t] = s_adv["finished"] & ~s_pre["finished"]
            tr["fail_d"][t] = s_adv["failed"] & ~s_pre["failed"]
            tr["requeue_d"][t] = s_adv["requeues"] > s_pre["requeues"]
            tr["start_d"][t] = st["started"] & ~s_adv["started"]
            if any_need:
                tr["j_star"][t] = dec[0].to(torch.int32)
                tr["fit"][t] = dec[1]
                tr["qlen"][t] = dec[2].to(torch.int32)
            if D:
                tr["drain_d"][t] = s_adv["drain_done"] & ~s_pre["drain_done"]
                tr["restore_d"][t] = (s_adv["restore_done"]
                                      & ~s_pre["restore_done"])
        if all_done and trace:
            # Every later round of the reference's scan is idle.
            tr["now"][t + 1:] = st["now"]
        if spans is not None:
            spans.close(2)
        if all_done:
            break

    out = {k: st[k] for k in (
        "started", "start", "end", "finished", "failed", "requeues",
        "failed_work", "failed_area", "first_start_j", "now", "decisions",
        "truncated", "first_start", "done")}
    out["actions"], out["decided"] = actions, decided
    if trace:
        # Final READY times decode the first queue entry of every job.
        out["trace"] = {**tr, "ready": st["ready"]}
    return out, obs_rows, rounds_run


# ====================================================================== host
def _state_device(policy_state) -> Optional[torch.device]:
    """The device of the policy's network, if it has one."""
    if isinstance(policy_state, torch.nn.Module):
        for p in policy_state.parameters():
            return p.device
    return None


class DeviceSimulator:
    """N jobsets, one shared cluster spec, one device round loop
    (reference: ``DeviceSimulator``).

    ``policy`` must implement the device stages of the ``Policy``
    protocol (``init_state`` / ``score_window``); use
    ``repro_torch.core.policy_api.supports_device`` to check.
    Construction packs the traces into fixed-capacity tensors on
    ``device`` (the card unless ``device="cpu"`` is asked for); ``run()``
    matches the ``Simulator`` result contract, ``rollout()`` additionally
    returns the decision trace (and, with ``collect=True``, the packed
    decision rows).

    ``faults`` mirrors the host engine: ``None``, one ``FaultSchedule``
    shared by every environment, or one (possibly ``None``) schedule per
    jobset.  ``spans`` (``repro_torch.obs.SpanRecorder``) records the
    packing as one ``setup.pack`` span.
    """

    def __init__(self, resources: Sequence[ResourceSpec],
                 jobsets: Sequence[Sequence[Job]], policy,
                 config: SimConfig | None = None, *, faults=None,
                 device=None, spans: Optional[SpanRecorder] = None):
        from ..core.agent import resolve_device
        from ..core.policy_api import supports_device
        if not supports_device(policy):
            raise TypeError(
                f"{type(policy).__name__} has no device stages "
                "(init_state/score_window) — run it through Simulator "
                "instead")
        if not jobsets or any(len(js) == 0 for js in jobsets):
            raise ValueError("DeviceSimulator needs >= 1 non-empty jobset")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.resources = list(resources)
        self.policy = policy
        self.config = config or SimConfig.for_engine("device")
        names = tuple(r.name for r in self.resources)
        caps = tuple(int(r.capacity) for r in self.resources)
        requires_obs = bool(getattr(policy, "requires_obs", True))
        enc = getattr(policy, "enc", None)
        if requires_obs:
            if enc is None:
                raise ValueError(
                    f"{type(policy).__name__} requires obs but has no enc")
            if tuple(enc.resource_names) != names:
                raise ValueError(
                    f"policy encodes resources {tuple(enc.resource_names)} "
                    f"but the cluster has {names}")
            if int(enc.window) != int(self.config.window):
                raise ValueError(
                    f"policy window {enc.window} != sim window "
                    f"{self.config.window} — the device engine scores "
                    "exactly the simulation window")
            enc_caps = tuple(int(c) for c in enc.capacities)
            time_scale = float(enc.time_scale)
            state_module, queue_cap = enc.state_module, int(enc.queue_cap)
        else:
            enc_caps = caps
            time_scale = 86400.0
            state_module, queue_cap = "mlp", 0
        state_dev = _state_device(policy.init_state())
        if state_dev is not None and state_dev != self.device:
            raise ValueError(
                f"the policy's network lives on {state_dev} but the device "
                f"engine runs on {self.device}")

        if spans is not None:
            spans.open("setup.pack")
        self.jobsets = [sorted((j.copy() for j in js),
                               key=lambda j: (j.submit, j.jid))
                        for js in jobsets]
        N = len(self.jobsets)
        J = max(len(js) for js in self.jobsets)
        caps_map = dict(zip(names, caps))
        if faults is None or isinstance(faults, FaultSchedule):
            flist = [faults] * N
        else:
            flist = list(faults)
            if len(flist) != N:
                raise ValueError(
                    f"got {len(flist)} fault schedules for {N} jobsets")
        self._faults = [resolve_faults(f, js, caps_map)
                        for f, js in zip(flist, self.jobsets)]
        rounds = 3 * J + 2 + self._fault_rounds()
        if self.config.max_rounds is not None:
            rounds = min(rounds, int(self.config.max_rounds))
        self.layout = DeviceLayout(
            names=names, caps=caps, enc_caps=enc_caps,
            window=int(self.config.window), n_envs=N, n_jobs=J,
            rounds=rounds, backfill=bool(self.config.backfill),
            requires_obs=requires_obs, time_scale=time_scale,
            state_module=state_module, queue_cap=queue_cap)
        self.arrays = self._pack(self.jobsets)
        self.faults_arrays = self._pack_faults(self._faults)
        if spans is not None:
            spans.close()
        self.stats = DeviceStats()

    def _fault_rounds(self) -> int:
        """Extra rounds for fault activity, max over environments: every
        kill adds one end pop and one restart decision; every drain adds
        its own pop, a restore pop, and a restart cycle per resident it
        can kill (bounded by the unit count)."""
        extra = 0
        for js, f in zip(self.jobsets, self._faults):
            kills = 0
            for job in js:
                k = 0
                for ft in job.fail_times:
                    if ft < job.runtime and k < f.max_requeues + 1:
                        k += 1
                    else:
                        break
                kills += k
            dcost = sum(2 + 2 * min(len(js), d.units) for d in f.drains)
            extra = max(extra, 2 * kills + dcost)
        return extra

    # ------------------------------------------------------------- packing
    def _tensor(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _pack(self, jobsets) -> Dict[str, torch.Tensor]:
        """Job tensors, built with numpy as the reference builds them and
        moved to the device once."""
        lay = self.layout
        N, J, R = lay.n_envs, lay.n_jobs, lay.n_resources
        submit = np.full((N, J), np.inf, np.float64)
        runtime = np.zeros((N, J), np.float64)
        walltime = np.zeros((N, J), np.float64)
        demands = np.zeros((N, J, R), np.float32)
        static = np.zeros((N, J, R + 1), np.float32)
        caps_f = [float(max(c, 1)) for c in lay.caps]
        # Dependency edges resolve to packed job indices per environment;
        # dangling or self deps are dropped (JobLifecycle semantics).
        dep_lists = []
        for js in jobsets:
            id2idx = {job.jid: j for j, job in enumerate(js)}
            dep_lists.append([
                [id2idx[d] for d in job.deps
                 if d in id2idx and d != job.jid]
                for job in js])
        P = max((len(ds) for env in dep_lists for ds in env), default=0)
        A = max((len(job.fail_times) for js in jobsets for job in js),
                default=0)
        deps_idx = np.full((N, J, P), -1, np.int32)
        think = np.zeros((N, J), np.float32)
        fail_times = np.full((N, J, A), np.inf, np.float32)
        for i, js in enumerate(jobsets):
            for j, job in enumerate(js):
                submit[i, j] = job.submit
                runtime[i, j] = job.runtime
                walltime[i, j] = job.walltime
                for r, n in enumerate(lay.names):
                    d = job.demands.get(n, 0)
                    demands[i, j, r] = d
                    static[i, j, r] = d / caps_f[r]       # f64 div, f32 store
                static[i, j, R] = job.walltime / lay.time_scale
                ds = dep_lists[i][j]
                deps_idx[i, j, :len(ds)] = ds
                think[i, j] = job.think_time
                fail_times[i, j, :len(job.fail_times)] = job.fail_times
        f32 = torch.float32
        return {
            "submit": self._tensor(submit, f32),
            "submit_feat": self._tensor(
                np.where(np.isfinite(submit), submit, 0.0), f32),
            "runtime": self._tensor(runtime, f32),
            "walltime": self._tensor(walltime, f32),
            "demands": self._tensor(demands),
            "static_feats": self._tensor(static),
            "deps_idx": self._tensor(deps_idx),
            "think": self._tensor(think),
            "fail_times": self._tensor(fail_times),
            "caps_f": self._tensor(np.asarray(caps_f, np.float32)),
        }

    def _pack_faults(self, resolved: List[FaultSchedule]) -> DeviceFaults:
        lay = self.layout
        N = lay.n_envs
        D = max((len(f.drains) for f in resolved), default=0)
        drain_t = np.full((N, D), np.inf, np.float32)
        restore_t = np.full((N, D), np.inf, np.float32)
        drain_res = np.zeros((N, D), np.int32)
        drain_units = np.zeros((N, D), np.int32)
        mr = np.zeros((N, 1), np.int32)
        res_idx = {n: r for r, n in enumerate(lay.names)}
        for i, f in enumerate(resolved):
            mr[i, 0] = f.max_requeues
            for k, d in enumerate(f.drains):
                drain_t[i, k] = d.time
                restore_t[i, k] = d.time + d.duration
                drain_res[i, k] = res_idx[d.resource]
                drain_units[i, k] = d.units
        unit_seg = np.concatenate(
            [np.full(cap, r, np.int32)
             for r, (_, cap) in enumerate(lay.segments)])
        unit_local = np.concatenate(
            [np.arange(cap, dtype=np.int32) for _, cap in lay.segments])
        return DeviceFaults(
            drain_t=self._tensor(drain_t), restore_t=self._tensor(restore_t),
            drain_res=self._tensor(drain_res),
            drain_units=self._tensor(drain_units),
            unit_seg=self._tensor(unit_seg),
            unit_local=self._tensor(unit_local),
            max_requeues=self._tensor(mr))

    # ------------------------------------------------------------- rollout
    def rollout(self, eps: Optional[float] = None, seed: int = 0,
                collect: bool = False, trace: bool = False,
                spans: Optional[SpanRecorder] = None) -> DeviceRollout:
        """Run every environment to completion (reference:
        ``DeviceSimulator.rollout``).

        ``eps``: when set, actions are epsilon-greedy with draws from a
        ``torch.Generator`` on the device seeded by ``seed`` (a different
        stream from the reference's ``jax.random`` and from the host
        engine's numpy draws).  ``collect=True`` additionally returns the
        packed decision rows.  ``trace=True`` records the per-round
        lifecycle deltas that ``emit_trace`` decodes into the
        ``mrsch.trace/v1`` event stream.  ``spans``
        (``repro_torch.obs.SpanRecorder``) records the rollout as a
        ``rollout`` span holding a ``round`` span per round the loop runs
        (``_device_rollout``) and the ``outputs`` span of the copies to the
        host, with a ``sync.*`` span around every device-to-host read.
        """
        if spans is not None:
            spans.start_rollout()
            spans.open("rollout")
        lay = self.layout
        explore = eps is not None
        gen = None
        if explore:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        sync = _SyncCounter(spans)
        with torch.no_grad(), \
                annotate("mrsch.device.rollout"):
            raw, obs_rows, rounds_run = _device_rollout(
                lay, self.policy.score_window, self.policy.init_state(),
                explore, float(eps or 0.0), gen, collect, trace, self.arrays,
                self.faults_arrays, sync, spans)
            if spans is not None:
                spans.round = -1
                spans.open("outputs")
            tr = raw.pop("trace", None)
            out = {k: v.cpu().numpy() for k, v in raw.items()}
            if tr is not None:
                tr = {k: v.cpu().numpy() for k, v in tr.items()}
            obs = None
            if collect:
                obs_dim = (lay.state_dim + 2 * lay.n_resources + lay.window
                           if lay.requires_obs else lay.window)
                obs = np.zeros((lay.rounds, lay.n_envs, obs_dim), np.float32)
                if obs_rows:
                    rows = torch.stack([o for _, o in obs_rows]).cpu().numpy()
                    obs[[t for t, _ in obs_rows]] = rows
            if spans is not None:
                spans.close()
        if not out["done"].all():
            raise RuntimeError(
                f"device rollout exhausted its round budget of "
                f"{lay.rounds} rounds (3J + 2 plus the fault rounds, "
                f"capped by SimConfig.max_rounds)")
        decided = out["decided"]
        self.stats = DeviceStats(
            rounds=int(decided.any(axis=1).sum()),
            decisions=int(decided.sum()),
            policy_calls=int(decided.any(axis=1).sum()),
            max_batch=int(decided.sum(axis=1).max(initial=0)),
            rounds_run=rounds_run, host_syncs=sync.n)
        if spans is not None:
            spans.close()
        return DeviceRollout(
            actions=out["actions"], decided=decided,
            stats=self.stats, obs=obs, trace=tr,
            _build=lambda: self._results(out))

    def emit_trace(self, ro: DeviceRollout, tracer: Tracer,
                   env_ids: Optional[Sequence[int]] = None) -> None:
        """Decode a ``rollout(trace=True)`` into typed tracer events
        (reference: ``DeviceSimulator.emit_trace``).

        Emits the event stream the sequential engine produces for the
        same jobsets/policy (canonical order restored by
        ``repro_torch.obs.trace.canonical_events``; exact on integer-time
        traces, where the f32 device clock is exact).
        """
        tr = ro.trace
        if tr is None:
            raise ValueError("rollout was not traced; pass trace=True")
        lay = self.layout
        eids = (list(range(lay.n_envs)) if env_ids is None
                else [int(e) for e in env_ids])
        if len(eids) != lay.n_envs:
            raise ValueError(
                f"got {len(eids)} env ids for {lay.n_envs} environments")
        # First queue entry of every job: its final READY time (f32).
        for i, js in enumerate(self.jobsets):
            env, ready_i = eids[i], tr["ready"][i]
            for j, job in enumerate(js):
                if np.isfinite(ready_i[j]):
                    tracer.job_queued(env, float(ready_i[j]), job.jid)
        nreq = [[0] * len(js) for js in self.jobsets]
        T = ro.decided.shape[0]
        has_faults = "drain_d" in tr
        for t in range(T):
            for i, js in enumerate(self.jobsets):
                env = eids[i]
                now = float(tr["now"][t, i])
                fin_d, fail_d = tr["finish_d"][t, i], tr["fail_d"][t, i]
                req_d = tr["requeue_d"][t, i]
                for j in np.flatnonzero(fin_d | fail_d | req_d):
                    jid = js[j].jid
                    if fin_d[j]:
                        tracer.job_finish(env, now, jid)
                    elif fail_d[j]:
                        # The kill that crossed the requeue bound: the
                        # host emits job.fail only (no requeue event).
                        tracer.job_fail(env, now, jid)
                    else:
                        nreq[i][j] += 1
                        tracer.job_requeue(env, now, jid, nreq[i][j])
                        tracer.job_queued(env, now, jid)
                if has_faults:
                    for k in np.flatnonzero(tr["drain_d"][t, i]):
                        d = self._faults[i].drains[k]
                        tracer.drain(env, now, d.resource, d.units)
                    for k in np.flatnonzero(tr["restore_d"][t, i]):
                        d = self._faults[i].drains[k]
                        tracer.restore(env, now, d.resource, d.units)
                if not ro.decided[t, i]:
                    continue
                a = int(ro.actions[t, i])
                j_star = int(tr["j_star"][t, i])
                fit = bool(tr["fit"][t, i])
                jid = js[j_star].jid
                tracer.decision(env, now, a, jid, int(tr["qlen"][t, i]),
                                1 if fit else 0)
                if fit:
                    tracer.job_start(env, now, jid, 0)
                else:
                    tracer.reserve(env, now, jid)
                    if lay.backfill:
                        bf = np.flatnonzero(tr["start_d"][t, i])
                        for j in bf:   # ascending index == queue order
                            tracer.job_start(env, now, js[j].jid, 1)
                        tracer.backfill(env, now, len(bf))

    def run(self) -> List[SimResult]:
        """Greedy rollout; result contract matches the host engine."""
        return self.rollout().results

    # ------------------------------------------------------------- results
    def _results(self, out) -> List[SimResult]:
        results = []
        for i, js in enumerate(self.jobsets):
            jobs = []
            for j, job in enumerate(js):
                job = job.copy()
                job.requeues = int(out["requeues"][i, j])
                job.failed_work = float(out["failed_work"][i, j])
                fs = float(out["first_start_j"][i, j])
                if fs >= 0.0:
                    job.first_start = fs
                if out["finished"][i, j]:
                    job.state = FINISHED
                elif out["failed"][i, j]:
                    job.state = FAILED
                if out["started"][i, j]:
                    job.start = float(out["start"][i, j])
                    e = float(out["end"][i, j])
                    job.end = e if np.isfinite(e) else -1.0
                jobs.append(job)
            started = [jb for jb in jobs if jb.started]
            cluster = Cluster(self.resources)
            acc = MetricsAccumulator(cluster)
            acc.last_time = float(out["now"][i])
            acc.start_time = (float(out["first_start"][i]) if started
                              else None)
            # Busy area = completed attempts' occupancy + the work lost to
            # killed attempts.  Drained units are phantom-owned, so they
            # contribute to neither term.
            for r, n in enumerate(self.layout.names):
                done_area = sum(
                    jb.demands.get(n, 0) * (jb.end - jb.start)
                    for jb in jobs if jb.state == FINISHED)
                acc.busy_area[n] = done_area + float(out["failed_area"][i, r])
            metrics = acc.summarize(started, all_jobs=jobs)
            metrics.truncated_jobs = int(out["truncated"][i])
            results.append(SimResult(
                metrics=metrics,
                jobs=jobs,
                makespan=float(out["now"][i]),
                decisions=int(out["decisions"][i]),
                n_unstarted=len(jobs) - len(started),
                truncated_jobs=int(out["truncated"][i]),
                requeues=metrics.requeues,
                n_failed=metrics.n_failed))
        return results


def run_traces_device(resources: Sequence[ResourceSpec],
                      jobsets: Sequence[Sequence[Job]], policy,
                      config: SimConfig | None = None, faults=None,
                      device=None) -> List[SimResult]:
    """Convenience device counterpart of ``run_trace`` (reference:
    ``run_traces_device``)."""
    cfg = config or SimConfig.for_engine("device")
    return DeviceSimulator(resources, jobsets, policy, cfg, faults=faults,
                           device=device).run()

"""Plain PyTorch versions of the window pack and of the device round's
front (the JAX package's ``kernels/window_pack/ref.py`` and the helpers of
``sim/device.py`` that ``decide`` calls before the policy scores): the CPU
path, and the oracles the CUDA kernels are held against on the card.

``pack_window_reference`` gathers the first ``W`` waiting jobs per
environment (queue order == ascending job index; the device engine keeps
traces sorted by submit time) into a dense window: their feature rows,
their job indices, and a validity mask.  It is written as the reference
writes it: an (N, W, J) one-hot selection contracted with ``einsum``.

``pack_decision_rows_reference`` is the whole front of a deciding round:
the queued mask, the free-unit counts, the pack and the packed decision
rows that the policy scores, as ``decide`` computed them op by op.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

# The values of ``sim.cluster.TTF_HORIZON`` and ``sim.lifecycle.PHANTOM_OWNER``
# (the kernels package does not import the simulator, which imports it).
TTF_HORIZON = 30.0 * 86400.0
PHANTOM_OWNER = -2

MODES = ("mask", "mlp", "attention")


@dataclass(frozen=True)
class DecisionRowSpec:
    """What the front of a round computes, fixed for one rollout.

    ``mode`` is ``"mask"`` for a policy that needs no observation (the row
    is the window's validity), else the state module's layout, ``"mlp"``
    or ``"attention"``.  ``k`` slots are packed: ``window`` (W), or the
    queue cap Q for the attention layout.  ``segments`` are the (offset,
    capacity) of every resource on the packed unit axis; ``enc_caps`` the
    encoding's section sizes; ``has_drains`` whether phantom-owned
    (drained) units exist, so that ``owner`` is read."""
    mode: str
    window: int
    k: int
    segments: Tuple[Tuple[int, int], ...]
    enc_caps: Tuple[int, ...]
    time_scale: float
    has_drains: bool

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"DecisionRowSpec: mode {self.mode!r} not in "
                             f"{MODES}")
        if not 1 <= self.window <= self.k:
            raise ValueError(f"DecisionRowSpec: need 1 <= window <= k, got "
                             f"window {self.window}, k {self.k}")
        if len(self.enc_caps) != len(self.segments) or not self.segments:
            raise ValueError("DecisionRowSpec: one enc_cap per segment, at "
                             "least one segment")

    @property
    def n_resources(self) -> int:
        return len(self.segments)

    @property
    def n_units(self) -> int:
        return sum(cap for _, cap in self.segments)

    @property
    def row_dim(self) -> int:
        """Width of one decision row."""
        R, W = self.n_resources, self.window
        if self.mode == "mask":
            return W
        if self.mode == "attention":
            return self.k * (R + 2) + 1 + 2 * R + 2 * R + W
        return W * (R + 2) + 2 * sum(self.enc_caps) + 2 * R + W

    @property
    def summed_columns(self) -> Tuple[int, ...]:
        """Row columns that sum over an axis: the goal (over the job axis)
        and the attention context's mean TTF (over units).  They depend on
        the order of summation, so two correct versions of the front may
        differ there in the last bits; every other column is exact."""
        R, W = self.n_resources, self.window
        if self.mode == "mask":
            return ()
        goal = tuple(range(self.row_dim - W - R, self.row_dim - W))
        if self.mode == "attention":
            ctx = self.k * (R + 2) + 1
            return tuple(ctx + 2 * r + 1 for r in range(R)) + goal
        return goal


class DecisionRows(NamedTuple):
    """Everything the rest of a deciding round reads, fresh each call."""
    waiting: torch.Tensor     # (N, J) float32 0/1 queued mask
    n_waiting: torch.Tensor   # (N,) float32
    free: torch.Tensor        # (N, R) float32 free-unit counts
    idx: torch.Tensor         # (N, K) int32 packed job indices
    valid: torch.Tensor       # (N, K) bool
    obs: torch.Tensor         # (N, spec.row_dim) float32 decision rows


def pack_window_reference(waiting: torch.Tensor, feats: torch.Tensor, *,
                          window: int):
    """waiting (N, J) 0/1, feats (N, J, F) ->
    (win_feats (N, W, F), win_idx (N, W) int32, win_valid (N, W) bool).

    Slot ``w`` holds the (w+1)-th waiting job in index order; slots past
    the number of waiting jobs are invalid with zero features and index 0.
    """
    J = waiting.shape[1]
    is_wait = waiting > 0.5
    csum = torch.cumsum(is_wait.to(torch.int32), dim=1)           # (N, J)
    slots = torch.arange(window, dtype=torch.int32,
                         device=waiting.device)[None, :, None]    # (1, W, 1)
    sel = is_wait[:, None, :] & (csum[:, None, :] == slots + 1)   # (N, W, J)
    win_feats = torch.einsum("nwj,njf->nwf", sel.to(feats.dtype), feats)
    jidx = torch.arange(J, dtype=torch.int32,
                        device=waiting.device)[None, None, :]
    win_idx = (sel * jidx).sum(dim=-1).to(torch.int32)
    win_valid = sel.any(dim=-1)
    return win_feats, win_idx, win_valid


def _queued(ready, now, started, finished, failed):
    """QUEUED mask: eligible by ``now`` and not in any other live state
    (reference: ``device_queued`` in ``src/repro/sim/lifecycle.py``, which
    ``decide`` in ``src/repro/sim/device.py`` calls)."""
    return (ready <= now[:, None]) & ~started & ~finished & ~failed


def _segment_free(spec: DecisionRowSpec, release: torch.Tensor) -> torch.Tensor:
    """Free-unit counts per resource, (N, R) float32 (reference:
    ``_segment_free`` in ``src/repro/sim/device.py``)."""
    cols = [(release[:, off:off + cap] == 0.0).sum(dim=1)
            for off, cap in spec.segments]
    return torch.stack(cols, dim=1).float()


def _meas_goal(spec: DecisionRowSpec, arrays, st, free, waiting,
               has_drains: bool):
    """Measurement (utilization) + Eq. (1) goal, (N, R) each (reference:
    ``_meas_goal`` in ``src/repro/sim/device.py``).  Drained
    (phantom-owned) units are neither busy nor free, matching
    ``Cluster.utilization``."""
    R = spec.n_resources
    now = st["now"]
    caps_f = arrays["caps_f"]
    if has_drains:
        phantom = torch.stack(
            [(st["owner"][:, off:off + cap] == PHANTOM_OWNER).sum(dim=1)
             for off, cap in spec.segments], dim=1).float()
        meas = 1.0 - (free + phantom) / caps_f[None, :]
    else:
        meas = 1.0 - free / caps_f[None, :]
    # Eq. (1) goal over the full waiting queue + running remainders.
    running = st["started"] & ~st["finished"]
    tw = (arrays["walltime"] * waiting
          + (st["est_end"] - now[:, None]).clamp_min(0.0) * running)
    acc = torch.einsum("nj,njr->nr", tw, arrays["demands"])
    demand_time = acc / caps_f[None, :]
    total = demand_time.sum(dim=1, keepdim=True)
    goal = torch.where(total > 0, demand_time / total.clamp_min(1e-30),
                       1.0 / R)
    return meas, goal


def _job_tokens(spec: DecisionRowSpec, st, win_feats, win_valid):
    """Packed job slots -> [fracs(R), walltime_norm, queued_norm] tokens
    (reference: ``_job_tokens`` in ``src/repro/sim/device.py``).  Invalid
    slots are all-zero."""
    R = spec.n_resources
    queued = ((st["now"][:, None] - win_feats[..., R + 1]) / spec.time_scale
              * win_valid.float())
    return torch.cat([win_feats[..., :R + 1], queued[..., None]], dim=-1)


def _build_obs(spec: DecisionRowSpec, st, win_feats, win_valid, meas, goal):
    """Packed decision rows [state | meas | goal | valid] on the device
    (reference: ``_build_obs`` in ``src/repro/sim/device.py``, mirroring
    ``encoding.encode_decision_row``; float32 throughout)."""
    R, W = spec.n_resources, spec.window
    N = st["now"].shape[0]
    ts = spec.time_scale
    now = st["now"]
    win = _job_tokens(spec, st, win_feats, win_valid)
    parts = [win.reshape(N, W * (R + 2))]
    # Unit sections use the encoding's reference section sizes; a cluster
    # with fewer units fills the leading slots (encode_state semantics).
    # The TTF_HORIZON clip keeps permanently drained units (release =
    # +inf) out of the features, matching encode_state.
    busy_all = st["release"] > 0.0
    avail_all = (~busy_all).float()
    ttf_all = torch.where(
        busy_all, (st["release"] - now[:, None]).clamp(0.0, TTF_HORIZON),
        0.0) / ts
    for r, (off, cap) in enumerate(spec.segments):
        k = min(cap, int(spec.enc_caps[r]))
        pad = int(spec.enc_caps[r]) - k
        avail = avail_all[:, off:off + k]
        ttf = ttf_all[:, off:off + k]
        if pad:
            zeros = avail.new_zeros((N, pad))
            avail = torch.cat([avail, zeros], dim=1)
            ttf = torch.cat([ttf, zeros], dim=1)
        parts.extend([avail, ttf])
    return torch.cat(parts + [meas, goal, win_valid.float()], dim=1)


def _build_obs_attention(spec: DecisionRowSpec, st, waiting, q_feats,
                         q_valid, meas, goal):
    """Attention-layout decision rows (reference: ``_build_obs_attention``
    in ``src/repro/sim/device.py``, mirroring ``encoding.encode_state``
    with ``state_module="attention"``):
    ``[Q*(R+2) tokens | queue_len | 2R context | meas | goal | valid(W)]``.
    ``q_feats``/``q_valid`` pack the first ``Q`` waiting jobs; the leading
    W slots are exactly the action window."""
    R, W, Q = spec.n_resources, spec.window, spec.k
    N = st["now"].shape[0]
    now = st["now"]
    tok = _job_tokens(spec, st, q_feats, q_valid)
    qlen = waiting.sum(dim=1).clamp_max(float(Q))
    ctx_cols = []
    for off, cap in spec.segments:
        seg = st["release"][:, off:off + cap]
        busy = seg > 0.0
        nb = busy.sum(dim=1).float()
        ctx_cols.append(1.0 - nb / float(max(cap, 1)))       # free fraction
        ttf_sum = torch.where(
            busy, (seg - now[:, None]).clamp(0.0, TTF_HORIZON),
            0.0).sum(dim=1)
        ctx_cols.append(torch.where(nb > 0, ttf_sum / nb.clamp_min(1.0), 0.0)
                        / spec.time_scale)                   # mean time-to-free
    return torch.cat([tok.reshape(N, Q * (R + 2)), qlen[:, None],
                      torch.stack(ctx_cols, dim=1), meas, goal,
                      q_valid[:, :W].float()], dim=1)


def pack_decision_rows_reference(
        spec: DecisionRowSpec, *, ready, now, started, finished, failed,
        release, est_end, feats, walltime, demands, caps_f,
        owner: Optional[torch.Tensor] = None) -> DecisionRows:
    """The front of a deciding round, op by op (reference: lines 588-610
    of ``_device_rollout.decide`` in ``src/repro/sim/device.py``).

    State: ready/est_end (N, J) float32, now (N,) float32, started/
    finished/failed (N, J) bool, release (N, U) float32, owner (N, U)
    int32 (read only with drains).  Per rollout: feats (N, J, R + 2)
    float32 (static fractions, walltime / time_scale, raw submit time),
    walltime (N, J), demands (N, J, R), caps_f (R,) float32."""
    st = {"now": now, "release": release, "owner": owner,
          "started": started, "finished": finished, "est_end": est_end}
    arrays = {"walltime": walltime, "demands": demands, "caps_f": caps_f}
    W = spec.window
    waiting = _queued(ready, now, started, finished, failed).float()
    n_waiting = waiting.sum(dim=1)
    free = _segment_free(spec, release)
    pk_feats, pk_idx, pk_valid = pack_window_reference(waiting, feats,
                                                       window=spec.k)
    if spec.mode == "mask":
        obs = pk_valid[:, :W].float()
    else:
        meas, goal = _meas_goal(spec, arrays, st, free, waiting,
                                spec.has_drains)
        if spec.mode == "attention":
            obs = _build_obs_attention(spec, st, waiting, pk_feats,
                                       pk_valid, meas, goal)
        else:
            obs = _build_obs(spec, st, pk_feats, pk_valid, meas, goal)
    return DecisionRows(waiting, n_waiting, free, pk_idx, pk_valid, obs)

"""The benchmark's arithmetic: published peaks, operations and bytes of the
kernels from their shapes and data, model FLOPs of a decision, and what
is read from the profiler's trace.  Nothing here imports the program.

Copied from ``chip_smoke.py`` at commit fe026a5: ``layer_cost`` from
``bound_ms`` (line 960), ``front_cost`` from ``front_bound`` (line 805),
``mha_cost`` from ``mha_bound_ms`` (line 2133, the forward), and
``device_events`` (line 977), which reads the profiler's raw records.
The copies return bytes and operations; ``bound_s`` turns them into a
time against the peaks below.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit.  Float32
# operands are counted against TF32's 495 TFLOP/s, the highest rate at
# which the card takes float32 inputs: a kernel that keeps float32
# results, by 3xTF32 on the tensor cores or by FMAs on the CUDA cores
# (67 TFLOP/s), can then never read above 100 %.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 495e12
PEAKS = ("H100 SXM data sheet (700 W): 3.35 TB/s HBM3; float32 operations "
         "at 495 TFLOP/s (TF32, dense)")

# Kernel names as the profiler records them (substrings).
B1_FORWARD = ("fused_mlp_fwd_kernel", "fused_mlp_fwd_m64_kernel",
              "splitk_epilogue_kernel")
B4 = ("decision_rows_kernel",)
B5 = ("mha_fwd_kernel",)


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the float32 peak, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S)


# ------------------------------------------------------------------ B1
def layer_cost(m: int, k: int, n: int) -> Tuple[float, float]:
    """(bytes, flops) of one float32 dense layer: x, W, b read once, y
    written once; 2MKN flops."""
    return 4.0 * (m * k + k * n + n + m * n), 2.0 * m * k * n


def forward_layers(cfg: dict, rows: int) -> List[Tuple[int, int, int]]:
    """(M, K, N) of every dense layer one forward of ``rows`` decision
    rows runs, in order."""
    a = cfg["agent"]
    R = len(cfg["cluster"]["capacities"])
    W, T = a["window"], len(a["offsets"])
    h, out, sh = a["module_hidden"], a["state_out"], a["stream_hidden"]
    layers = []
    if a["state_module"] == "attention":
        d, Q = a["attn_dim"], a["queue_cap"]
        S = Q + 1
        layers += [(rows * Q, R + 2, d), (rows, 2 * R, d)]
        for _ in range(a["attn_layers"]):
            layers += [(rows * S, d, d)] * 4
            layers += [(rows * S, d, a["attn_mlp_mult"] * d),
                       (rows * S, a["attn_mlp_mult"] * d, d)]
        layers.append((rows, d * (2 + W), out))
    else:
        sizes = [W * (R + 2) + 2 * sum(cfg["cluster"]["capacities"]),
                 *a["state_hidden"], out]
        layers += [(rows, sizes[i], sizes[i + 1])
                   for i in range(len(sizes) - 1)]
    for sizes in ([R, h, h, h], [R, h, h, h], [out + 2 * h, sh, T * R],
                  [out + 2 * h, sh, W * T * R]):
        layers += [(rows, sizes[i], sizes[i + 1])
                   for i in range(len(sizes) - 1)]
    return layers


def b1_forward_bound_s(cfg: dict, rows: int) -> float:
    return sum(bound_s(*layer_cost(*mkn)) for mkn in forward_layers(cfg, rows))


# ------------------------------------------------------------------ B4
@dataclass(frozen=True)
class FrontCall:
    """What one call of the round's front read and wrote, for its cost."""
    n: int                  # environments
    j: int                  # job slots
    waiting: int            # waiting jobs over the environments
    running: int            # running jobs
    in_goal: int            # jobs in the goal: waiting or running
    selected: int           # packed slots that hold a job


def front_cost(call: FrontCall, R: int, U: int, K: int, row_dim: int,
               rows: bool = True, has_drains: bool = False):
    """(bytes, ops) of one call: the job flags, ``now`` and ``release``
    read whole; where the rows carry the goal, walltime only of the
    waiting jobs, est_end only of the running ones, demands only of their
    union, feature rows only of the selected jobs; each output written
    once.  Per job 4 compares and, for a job in the goal, 3 + 2R flops;
    per unit 6; per selected slot 2."""
    n, j = call.n, call.j
    read = n * (j * (4 + 3) + 4 + 4 * U) + 4 * R
    if has_drains:
        read += 4 * n * U
    ops = n * j * 4 + 6 * n * U + 2 * call.selected
    if rows:
        read += (4 * call.waiting + 4 * call.running
                 + 4 * R * call.in_goal + 4 * (R + 2) * call.selected)
        ops += (3 + 2 * R) * call.in_goal
    written = n * (4 * j + 4 + 4 * R + 4 * K + K + 4 * row_dim)
    return read + written, ops


# ------------------------------------------------------------------ B5
def mha_cost(kept_keys: int, bh: int, sq: int, dh: int):
    """(bytes, flops) of one masked attention forward: q read once, k and
    v read for the kept keys only, o and lse written once; two FMAs of dh
    per (query, kept key), two flops each.  ``kept_keys`` sums, over the
    batch-head rows, the keys within each row's length."""
    rows = bh * sq
    kv = 2 * kept_keys * dh + bh
    nbytes = rows * dh + kv + rows * dh + rows
    return 4.0 * nbytes, 2.0 * (2 * sq * kept_keys * dh)


# ------------------------------------------------------------------ MFU
def decision_flops(cfg: dict, queue_len=0):
    """Model FLOPs of one decision's forward row: every dense layer's 2KN
    per row it needs, the encoder at the tokens the queue holds (up to Q)
    plus the context token, with attention's two FMAs of the head width
    per (query, key) pair of those tokens.  ``queue_len`` may be an array
    of decisions' queue lengths."""
    a = cfg["agent"]
    layers = forward_layers(cfg, 1)
    if a["state_module"] != "attention":
        return sum(2.0 * k * n for _, k, n in layers)
    R, W, d = len(cfg["cluster"]["capacities"]), a["window"], a["attn_dim"]
    L = np.minimum(np.asarray(queue_len, np.float64), a["queue_cap"])
    tokens = L + 1.0
    per_token = 4 * d * d + 2 * d * a["attn_mlp_mult"] * d
    f = 2.0 * (L * (R + 2) * d + 2 * R * d)
    f = f + a["attn_layers"] * (2.0 * tokens * per_token
                                + 2.0 * 2 * tokens * tokens * d)
    f = f + 2.0 * d * (2 + W) * a["state_out"]
    n_state = 3 + 6 * a["attn_layers"]
    return f + sum(2.0 * k * n for _, k, n in layers[n_state:])


# ------------------------------------------------------------------ trace
@dataclass
class DeviceOp:
    name: str
    count: int = 0
    seconds: float = 0.0


@dataclass
class DeviceTrace:
    """The device's activity in the traced window."""
    ops: Dict[str, DeviceOp]
    intervals: List[Tuple[int, int, str]]     # (start ns, end ns, name)

    def seconds(self, names: Sequence[str]) -> float:
        return sum(op.seconds for k, op in self.ops.items()
                   if any(n in k for n in names))

    def count(self, names: Sequence[str]) -> int:
        return sum(op.count for k, op in self.ops.items()
                   if any(n in k for n in names))

    @property
    def n_ops(self) -> int:
        return sum(op.count for op in self.ops.values())


def device_events(prof) -> DeviceTrace:
    """The profile's events that ran on the card (kernels, copies, fills),
    summed by name, from the profiler's raw records; an operator's own
    entry also carries its kernels' time, so only device records count."""
    from torch.autograd import DeviceType
    ops: Dict[str, DeviceOp] = {}
    intervals = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or getattr(e, "is_hidden_event", lambda: False)()
                or e.name().startswith("[")):
            continue
        op = ops.setdefault(e.name(), DeviceOp(e.name()))
        op.count += 1
        op.seconds += e.duration_ns() / 1e9
        t0 = e.start_ns()
        intervals.append((t0, t0 + e.duration_ns(), e.name()))
    intervals.sort()
    return DeviceTrace(ops, intervals)


def busy_seconds(intervals: Iterable[Tuple[int, int, str]]) -> float:
    """Length of the union of the device intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e, _ in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template and
    arguments."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void\s+", "", s.split("(")[0])
    depth, out = 0, []
    for ch in s:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    return "".join(out).strip().split("::")[-1][:96] or name[:96]


def breakdown(trace: DeviceTrace, top: int = 10) -> dict:
    """The device operations that took most time, summed by short name,
    and the idle time between device operations summed by what the host
    issued around it (the operation before the gap and the one after)."""
    ops: Dict[str, float] = {}
    for op in trace.ops.values():
        key = short_name(op.name)
        ops[key] = ops.get(key, 0.0) + op.seconds
    gaps: Dict[str, float] = {}
    end, prev = None, None
    for s, e, name in trace.intervals:
        if end is not None and s > end:
            key = f"{short_name(prev)} -> {short_name(name)}"
            gaps[key] = gaps.get(key, 0.0) + (s - end) / 1e9
        if end is None or e >= end:
            end, prev = e, name
    return {"device_ops": [[k, v] for k, v in
                           sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}

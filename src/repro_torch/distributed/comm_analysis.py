"""Collective traffic, flops, bytes and roofline terms of one dispatched
step: the port's counterpart of the JAX package's
``distributed/hlo_analysis.py``.

The reference lowers each cell to a compiled HLO module and reads its
collectives from the module's text and its flops and bytes from XLA's
cost analysis.  The port runs eagerly: there is no HLO.  So a cell is
counted as it dispatches, with ``StepCounter``, a ``TorchDispatchMode``
that counts each op once, as rank 0 runs it, and a second mode beneath it
that sees the collectives DTensor desugars each op into (as
``torch.distributed.tensor.debug.CommDebugMode`` does):

* collectives — each ``_c10d_functional`` op, sized by its tensors, with
  the reference's ring models of the bytes one rank puts on the wire,
  n = the ranks of the op's group:

    all-gather        S_result * (n-1)/n
    reduce-scatter    S_operand * (n-1)/n
    all-reduce        2 * S * (n-1)/n         (ring RS + AG)
    all-to-all        S * (n-1)/n
    broadcast         S                       (one hop)

* flops — ``torch.utils.flop_counter``'s formulas (the ones
  ``FlopCounterMode`` uses: matmuls, attention, convolutions).  An op on
  DTensors is counted at its global shapes, as ``FlopCounterMode`` counts
  it, and divided by the product of the mesh dims on which its output is
  sharded or partial, the ranks that split its work; a mesh dim on which
  the output is replicated repeats the work on every rank, as the
  reference's per-device HLO count does.  An op on plain tensors (the
  local shards that a model reaches through ``to_local``: the MoE paths,
  ``tp_row_matmul``, the attention and SSD cores) is counted at its own,
  local, shapes.
* bytes — each op's tensor inputs read once and its outputs written once
  (views and collectives excluded).  Nothing is fused, so this is an
  upper bound on the memory traffic: a fused kernel keeps intermediates
  in registers and shared memory.
* memory — the peak of the results made under the mode and still alive
  (each freed when its tensor is), the step's temporaries.

The whole step is counted, every layer and every block of the blockwise
attention scan, so nothing is extrapolated from shallower programs.
``roofline_terms`` turns the counts into times on ``H100_SXM``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class _CollectiveCounter(TorchDispatchMode):
    """Sees what DTensor desugars an op into (it returns NotImplemented on
    a DTensor op, as ``CommDebugMode`` does) and records each collective
    op with its bytes on the wire."""

    def __init__(self):
        super().__init__()
        self.ops: List[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            self._record(func._schema.name.split("::")[-1], args, out)
        return out

    def _record(self, name: str, args, out) -> None:
        kind = _COLLECTIVES.get(name)
        if kind is None:                     # wait_tensor and the like
            return
        n = _group_size(args[-1])
        if n <= 1:
            return
        frac = (n - 1) / n
        if kind == "reduce-scatter":
            size = sum(_nbytes(t) for t in _tensors(args[0]))
            wire = size * frac
        else:
            size = sum(_nbytes(t) for t in _tensors(out))
            wire = {"all-reduce": 2 * size * frac, "broadcast": size
                    }.get(kind, size * frac)
        self.ops.append({"kind": kind, "bytes": size, "group": n,
                         "wire_bytes": wire})


class StepCounter(TorchDispatchMode):
    """Counts one rank's collectives, flops and bytes while active.

    An op on DTensors is counted whole, before DTensor runs it (this
    mode is off while it does, so the ops DTensor runs to infer shapes
    are not counted): its flops at the global shapes over the ranks that
    split the work, the mesh dims on which its output is sharded or
    partial (a dim it is replicated on repeats the work on every rank);
    its bytes those of its operands' and results' local shards.  An op
    on plain tensors (the local paths that a model takes through
    ``to_local``) is counted at its own shapes.  The collectives are
    counted by a second mode beneath, which sees what DTensor desugars
    each op into."""

    def __init__(self):
        super().__init__()
        self._comm = _CollectiveCounter()
        self.flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.live_bytes = 0        # results made under the mode, alive
        self.peak_bytes = 0
        self._tracked = set()

    @property
    def ops(self) -> List[dict]:
        return self._comm.ops

    @property
    def wire_bytes(self) -> float:
        return sum(o["wire_bytes"] for o in self.ops)

    def by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for o in self.ops:
            out[o["kind"]] = out.get(o["kind"], 0.0) + o["wire_bytes"]
        return out

    def count(self) -> int:
        return len(self.ops)

    def __enter__(self):
        self._comm.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        return self._comm.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in ("_c10d_functional", "c10d_functional") \
                or _is_view(func):
            return out
        self.n_ops += 1
        split = 1
        if any(issubclass(t, DTensor) for t in types):
            res = [t for t in _tensors(out) if isinstance(t, DTensor)]
            if res:
                split = _split(res[0])
        self.flops += op_flops(func, args, kwargs, out) / split
        self.bytes += sum(_local_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_local_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        """Count a new result's local bytes as live until it is freed
        (an in-place op's result is its operand, already counted)."""
        if id(t) in self._tracked:
            return
        n = _local_nbytes(t)
        self._tracked.add(id(t))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(t, self._free, id(t), n)

    def _free(self, key: int, n: int) -> None:
        self._tracked.discard(key)
        self.live_bytes -= n


def op_flops(func, args, kwargs, out) -> float:
    """Flops of one op at its operands' shapes: ``torch.utils.
    flop_counter``'s formula where it has one, else the two composite
    products that DTensor sees whole (``matmul``: 2 * out * K;
    ``einsum``: 2 * the product of every index's size when an index is
    summed); 0 for any other op."""
    from torch.utils.flop_counter import flop_registry
    packet = func._overloadpacket
    if packet in flop_registry:
        return flop_registry[packet](*args, **kwargs, out_val=out)
    name = func._schema.name
    if name == "aten::matmul":
        return 2.0 * out.numel() * args[0].shape[-1]
    if name == "aten::einsum":
        eq, operands = args[0].replace(" ", ""), args[1]
        lhs, _, rhs = eq.partition("->")
        sizes = {}
        for sub, t in zip(lhs.split(","), operands):
            sizes.update(zip(sub, t.shape))
        n = 1.0
        for d in sizes.values():
            n *= d
        summed = set(sizes) - set(rhs)
        return 2.0 * n if summed else n
    return 0.0


def _split(t) -> int:
    """The ranks over which a DTensor's producing op split its work: the
    product of the mesh dims on which ``t`` is sharded or partial."""
    from torch.distributed.tensor import Replicate
    n = 1
    for size, p in zip(t.device_mesh.shape, t.placements):
        if not isinstance(p, Replicate):
            n *= size
    return n


def _local_nbytes(t: torch.Tensor) -> int:
    local = getattr(t, "_local_tensor", t)
    return _nbytes(local)


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


@dataclass(frozen=True)
class Hardware:
    """Per-card peaks of the port's target, an NVIDIA H100 SXM (80 GB
    HBM3), from NVIDIA's H100 datasheet: dense bfloat16 tensor-core
    flops, HBM bandwidth, and NVLink 4's bandwidth per direction (18 links
    of 25 GB/s each way; the datasheet's 900 GB/s counts both ways)."""
    peak_bf16_flops: float = 989e12
    hbm_bw: float = 3.35e12
    link_bw: float = 450e9
    hbm_gb: float = 80.0


H100_SXM = Hardware()


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   wire_bytes_per_device: float, hw: Hardware = H100_SXM
                   ) -> Dict[str, float]:
    t_c = flops_per_device / hw.peak_bf16_flops
    t_m = bytes_per_device / hw.hbm_bw
    t_n = wire_bytes_per_device / hw.link_bw
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_n),
              key=lambda kv: kv[1])
    bound = max(t_c, t_m, t_n)
    return {
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
        "dominant": dom[0],
        "roofline_fraction": t_c / bound if bound > 0 else 0.0,
    }

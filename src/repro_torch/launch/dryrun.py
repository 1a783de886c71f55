"""Multi-pod dry run: count every (arch x shape x mesh) cell's step at full
width and full depth on a fake world (the JAX package's
``launch/dryrun.py``).

    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--rules baseline|opt|serve]
        [--microbatches N] [--out DIR] [--force]

One process stands for all 256 (or 512) ranks of the production mesh:
``torch.distributed``'s ``"fake"`` backend (a testing backend whose
collectives do nothing) gives the world, ``launch.mesh`` the mesh, and
``launch.steps.build_cell`` the cell's step and its DTensor arguments,
fake tensors with no storage.  The step then runs once as rank 0 under
``distributed.comm_analysis.StepCounter`` (collectives, flops, bytes and
the peak of live temporaries), and ``run_cell`` writes one record with
the reference's keys where they exist (``flops_per_device`` and
``bytes_per_device`` stand for its ``hlo_*`` counts) and ``counter``,
which names what counted them.  Every layer and every
attention block dispatches, so nothing is extrapolated from L = 1 and
L = 2 programs and nothing needs ``flash_correction``.  No card is used.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import SHAPE_ORDER, SHAPES, all_configs, cell_supported, get_config
from ..distributed.collectives import to_local
from ..distributed.comm_analysis import H100_SXM, StepCounter, roofline_terms
from ..distributed.costs import cell_costs
from ..distributed.sharding import RULE_SETS, default_rules
from .mesh import make_production_mesh
from .steps import build_cell

RESULTS_DIR = os.environ.get("REPRO_RESULTS", "results/dryrun_torch")
COUNTER = ("torch dispatch on a fake world, as rank 0: flops by "
           "torch.utils.flop_counter formulas, a DTensor op at its global "
           "shapes divided by the mesh dims on which its output is sharded "
           "or partial, a plain op (local shards) at its own shapes; "
           "_c10d_functional collectives on ring models; bytes of local "
           "shards unfused (inputs read and outputs written once per op, "
           "an upper bound); temporaries the peak of live results")


def fake_world(n_ranks: int) -> None:
    """A ``"fake"`` process group of ``n_ranks`` in this process, rank 0
    (an initialised world of another size is torn down first), with
    DTensor's sharding-propagation caches emptied: a cached spec keeps the
    mesh it was made on, and the mesh of an earlier cell compares equal to
    this cell's, so an op would be handed the earlier mesh, and with it
    process groups of a world that is gone."""
    from torch.distributed.tensor import debug
    debug._clear_sharding_prop_cache()
    if dist.is_initialized():
        if dist.get_world_size() == n_ranks and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)


def _tensor_bytes(tree) -> dict:
    """{id of the tensor: its local shard's bytes} of the tensors in
    ``tree`` (modules' parameters included)."""
    from torch.utils._pytree import tree_flatten
    out = {}
    for leaf in tree_flatten(tree)[0]:
        ts = (list(leaf.parameters()) if isinstance(leaf, torch.nn.Module)
              else [leaf] if isinstance(leaf, torch.Tensor) else [])
        for t in ts:
            shard = to_local(t)
            out[id(t)] = shard.numel() * shard.element_size()
    return out


def _run_counted(step, args):
    counter = StepCounter()
    t0 = time.time()
    with counter:
        out = step(*args)
    return out, counter, time.time() - t0


def run_cell(arch: str, sname: str, multi_pod: bool, rules_fn=default_rules,
             tag: str = "", microbatches: int = 1) -> dict:
    """One cell's record (the port counts the full program: the
    reference's ``extrapolate`` has no counterpart)."""
    cfg = get_config(arch)
    shape = SHAPES[sname]
    ok, reason = cell_supported(cfg, shape)
    rec = {"arch": arch, "shape": sname,
           "mesh": "2x16x16" if multi_pod else "16x16", "tag": tag}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    n_chips = 512 if multi_pod else 256
    try:
        fake_world(n_chips)
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = rules_fn(mesh)
        t0 = time.time()
        step, args = build_cell(cfg, shape, rules, microbatches=microbatches)
        build_s = time.time() - t0
        arg_bytes = _tensor_bytes(args)
        out, counter, run_s = _run_counted(step, args)
    except Exception as e:
        rec.update(status="failed", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        return rec
    out_bytes = _tensor_bytes(out)
    alias = sum(b for k, b in out_bytes.items() if k in arg_bytes)
    argument = sum(arg_bytes.values())
    output = sum(out_bytes.values())
    temp = counter.peak_bytes
    costs = cell_costs(cfg, shape)
    flops_dev, bytes_dev, wire_dev = (counter.flops, counter.bytes,
                                      counter.wire_bytes)
    rec.update(
        status="ok", build_s=build_s, run_s=run_s,
        mem=dict(argument_bytes=argument, output_bytes=output,
                 temp_bytes=temp, alias_bytes=alias,
                 total_hbm_gb=(argument + output + temp - alias) / 1e9),
        flops_per_device=flops_dev,
        bytes_per_device=bytes_dev,
        wire_bytes_per_device=wire_dev,
        collective_ops=counter.count(),
        collective_bytes_by_kind=counter.by_kind(),
        dispatched_ops=counter.n_ops,
        model_flops_global=costs.model_flops_global,
        model_flops_per_device=costs.model_flops_global / n_chips,
        useful_ratio=(costs.model_flops_global / n_chips)
        / max(flops_dev, 1.0),
        roofline=roofline_terms(flops_dev, bytes_dev, wire_dev),
        hardware=dict(H100_SXM.__dict__), counter=COUNTER,
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="single arch (default all)")
    ap.add_argument("--shape", default=None, help="single shape (default all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--no-extrapolate", action="store_true",
                    help="the reference's flag; the port counts the full "
                         "program either way")
    ap.add_argument("--rules", default="baseline", choices=list(RULE_SETS))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--force", action="store_true", help="recompute cached")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else list(all_configs())
    shapes = [args.shape] if args.shape else SHAPE_ORDER
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for sname in shapes:
            for multi in meshes:
                cell_id = f"{arch}__{sname}__{'multi' if multi else 'single'}"
                if args.rules != "baseline":
                    cell_id += f"__{args.rules}"
                if args.microbatches > 1:
                    cell_id += f"__mb{args.microbatches}"
                path = os.path.join(args.out, cell_id + ".json")
                if os.path.exists(path) and not args.force:
                    with open(path) as fh:
                        rec = json.load(fh)
                    print(f"[cached] {cell_id}: {rec['status']}")
                    continue
                t0 = time.time()
                rec = run_cell(arch, sname, multi,
                               rules_fn=RULE_SETS[args.rules],
                               tag=args.rules,
                               microbatches=args.microbatches)
                rec["wall_s"] = time.time() - t0
                with open(path, "w") as fh:
                    json.dump(rec, fh, indent=1)
                line = f"[{rec['status']:7s}] {cell_id} ({rec['wall_s']:.0f}s)"
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    line += (f" mem={rec['mem']['total_hbm_gb']:.2f}GB/dev"
                             f" dom={r['dominant']}"
                             f" frac={r['roofline_fraction']:.2f}")
                elif rec["status"] == "failed":
                    failures += 1
                    line += " " + rec.get("error", "")[:160]
                print(line, flush=True)
    print(f"done; failures={failures}")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())

"""Training driver of the LM zoo (the JAX package's ``launch/train.py``):
real steps on the cards of a mesh, on one card, or on the CPU when asked.

    python -m repro_torch.launch.train --arch gemma-2b --steps 20
    torchrun --nproc_per_node 8 -m repro_torch.launch.train --arch gemma-2b
    python -m repro_torch.launch.train --arch gemma-2b --smoke --device cpu

``train_loop`` draws the weights from a seeded ``torch.Generator`` (not
the reference's ``jax.random`` numbers), takes the deterministic batches
of ``data.make_batch`` (the reference's for the same seed and step), and
runs ``make_train_step`` (the ``"torch"`` backend, remat on) under a
cosine schedule.  Fault tolerance as in the reference: an async
checkpoint of ``{"params", "opt"}`` every ``ckpt_every`` steps, in the
reference's stacked layout (``convert.lm_params_to_tree``, the AdamW
state's own tree), so either package resumes the other's run; restore of
the latest step; and a SIGTERM saves synchronously at the next step
boundary and ends the loop.

On a mesh (``mesh=``, or the host mesh of an initialised process group,
as ``torchrun`` forms it) the step runs under ``default_rules``: the
parameters FSDP-sharded over "data" and tensor-parallel over "model" as
``param_pspecs`` lays them out, drawn module by module so that no card
holds the whole model (``init_sharded_params``), the AdamW state by
``param_pspecs_for_opt``, each step's batch by ``batch_pspec`` (every rank
makes the same global batch).  Checkpoints gather on every rank, the
mesh's first rank writes them, and a resume lays them out on this mesh,
whatever number of ranks wrote them.  A SIGTERM to any rank stops every
rank at the same step boundary: the flag is reduced over the world each
step.  Without a mesh or a process group the model lives on one card.
"""
from __future__ import annotations

import argparse
import json
import signal
import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import InputShape, get_config, smoke_config
from ..convert import lm_params_to_tree, load_lm_tree
from ..core.agent import resolve_device
from ..data.pipeline import DataConfig, make_batch
from ..distributed.sharding import (default_rules, distribute_tree,
                                    mesh_device, named_shardings,
                                    param_pspecs, zeros_tree)
from ..models import transformer
from ..optim import OptConfig, make_schedule, opt_init
from .mesh import join_world, make_host_mesh
from .steps import (_bind_rules, batch_pspec, init_sharded_params,
                    make_train_step, param_pspecs_for_opt, param_tree_pspecs)


@dataclass
class TrainRun:
    steps: int
    losses: list
    wall_s: float
    restored_from: Optional[int]


def _value(x) -> float:
    """A step metric as a float (a DTensor's whole value)."""
    return float(x.full_tensor() if hasattr(x, "full_tensor") else x)


def train_loop(cfg, shape: InputShape, *, steps: int = 20,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
               mesh=None, dtype=torch.float32,
               opt: Optional[OptConfig] = None, log_every: int = 5,
               seed: int = 0, resume: bool = True, device=None) -> TrainRun:
    """Train ``cfg`` from seed ``seed`` for steps [start, ``steps``), where
    start is the latest checkpoint's step under ``ckpt_dir`` (0 without
    one, or without ``resume``).  Logs and records the loss every
    ``log_every`` steps and at the last.  On ``mesh`` (a ("data",
    "model") ``DeviceMesh``; ``None`` means ``make_host_mesh()`` when a
    process group is initialised), every rank of the world calls it
    alike and only the mesh's first rank logs; else on the card unless
    ``device`` says otherwise."""
    if mesh is None and dist.is_initialized():
        mesh = make_host_mesh()
    opt = opt or OptConfig(lr=1e-3, weight_decay=0.0)
    sched = make_schedule("cosine", peak=opt.lr,
                          warmup_steps=max(steps // 10, 1), total_steps=steps)
    step_fn = make_train_step(cfg, opt, remat=True, lr_schedule=sched)
    if mesh is None:
        device = resolve_device(device)
        params = transformer.init_params(
            cfg, generator=torch.Generator(device).manual_seed(seed),
            device=device, dtype=dtype)
        opt_state = opt_init(params, opt)
        rules = shardings = None
        lead = True
    else:
        device = mesh_device(mesh)
        rules = default_rules(mesh)
        params = init_sharded_params(
            cfg, rules, generator=torch.Generator(device).manual_seed(seed),
            dtype=dtype)
        pspecs = param_pspecs(params, rules)
        # Shapes on the meta device, then each rank's shards: no card
        # holds a whole moment, and a restore reads into the shards.
        meta = {"params": lm_params_to_tree(
                    transformer.LM(cfg, dtype, "meta")),
                "opt": opt_init(params, opt, "meta")}
        opt_specs = param_pspecs_for_opt(meta["opt"], pspecs)
        opt_state = zeros_tree(meta["opt"], opt_specs, mesh)
        shardings = named_shardings(
            {"params": param_tree_pspecs(params, pspecs), "opt": opt_specs},
            mesh)
        step_fn = _bind_rules(step_fn, rules)
        lead = dist.get_rank() == 0

    start_step = 0
    restored = None
    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if manager is not None and resume:
        try:
            state, manifest = manager.restore_latest(
                meta if mesh is not None else
                {"params": lm_params_to_tree(params), "opt": opt_state},
                shardings=shardings)
        except FileNotFoundError:
            pass
        else:
            load_lm_tree(params, state["params"])
            opt_state = state["opt"]
            start_step = restored = manifest["step"]

    # Preemption safety: SIGTERM asks for a synchronous save and an end
    # at the next step boundary.
    interrupted = {}
    handlers = []                     # the handler to put back at the end
    if manager is not None:
        def _on_term(signum, frame):
            interrupted["now"] = True
        try:
            handlers.append(signal.signal(signal.SIGTERM, _on_term))
        except ValueError:
            pass                      # not the main thread (tests)

    def stop() -> bool:
        """Whether any rank was asked to stop: every rank checks at every
        step boundary, so all of them stop at the same one."""
        if mesh is None or manager is None:
            return bool(interrupted)
        flag = torch.tensor([int(bool(interrupted))], device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def snapshot():
        return {"params": lm_params_to_tree(params), "opt": opt_state}

    losses = []
    t0 = time.time()
    step = start_step
    try:
        for step in range(start_step, steps):
            batch = make_batch(cfg, shape, step, DataConfig(seed=seed),
                               dtype, device)
            if rules is not None:
                batch = distribute_tree(batch, batch_pspec(rules, batch),
                                        mesh)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step % log_every == 0 or step == steps - 1:
                loss = _value(metrics["loss"])
                gnorm = _value(metrics["grad_norm"])
                losses.append(loss)
                if lead:
                    print(f"[train] step {step} loss {loss:.4f} "
                          f"gnorm {gnorm:.3f}", flush=True)
            if manager is not None and (step + 1) % ckpt_every == 0:
                manager.save_async(snapshot(), step + 1)
            if stop():
                manager.save(snapshot(), step + 1)
                if lead:
                    print(f"[train] preempted at step {step + 1}; "
                          f"checkpoint flushed", flush=True)
                break
        if manager is not None:
            manager.wait()
    finally:
        for h in handlers:
            signal.signal(signal.SIGTERM, h)
    return TrainRun(steps=step + 1 - start_step, losses=losses,
                    wall_s=time.time() - t0, restored_from=restored)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (gloo under torchrun); the "
                         "card when unset")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = InputShape("cli", args.seq, args.batch, "train")
    mesh = join_world(args.device)
    try:
        run = train_loop(cfg, shape, steps=args.steps, ckpt_dir=args.ckpt,
                         mesh=mesh, device=args.device)
        if mesh is None or dist.get_rank() == 0:
            print(json.dumps({"steps": run.steps,
                              "final_loss": run.losses[-1],
                              "wall_s": run.wall_s}))
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

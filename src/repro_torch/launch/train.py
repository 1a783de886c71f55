"""Training driver of the LM zoo (the JAX package's ``launch/train.py``):
real steps on one card, or on the CPU when asked.

    python -m repro_torch.launch.train --arch gemma-2b --steps 20
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
boundary and ends the loop.  One card holds the model: there is no mesh.
"""
from __future__ import annotations

import argparse
import json
import signal
import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..checkpoint import CheckpointManager
from ..configs import InputShape, get_config, smoke_config
from ..convert import lm_params_to_tree, load_lm_tree
from ..core.agent import resolve_device
from ..data.pipeline import DataConfig, make_batch
from ..models import transformer
from ..optim import OptConfig, make_schedule, opt_init
from .steps import make_train_step


@dataclass
class TrainRun:
    steps: int
    losses: list
    wall_s: float
    restored_from: Optional[int]


def train_loop(cfg, shape: InputShape, *, steps: int = 20,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
               dtype=torch.float32, opt: Optional[OptConfig] = None,
               log_every: int = 5, seed: int = 0, resume: bool = True,
               device=None) -> TrainRun:
    """Train ``cfg`` from seed ``seed`` for steps [start, ``steps``), where
    start is the latest checkpoint's step under ``ckpt_dir`` (0 without
    one, or without ``resume``).  Logs and records the loss every
    ``log_every`` steps and at the last; on the card unless ``device``
    says otherwise."""
    device = resolve_device(device)
    opt = opt or OptConfig(lr=1e-3, weight_decay=0.0)
    sched = make_schedule("cosine", peak=opt.lr,
                          warmup_steps=max(steps // 10, 1), total_steps=steps)
    params = transformer.init_params(
        cfg, generator=torch.Generator(device).manual_seed(seed),
        device=device, dtype=dtype)
    opt_state = opt_init(params, opt)
    step_fn = make_train_step(cfg, opt, remat=True, lr_schedule=sched)

    start_step = 0
    restored = None
    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if manager is not None and resume:
        try:
            state, manifest = manager.restore_latest(
                {"params": lm_params_to_tree(params), "opt": opt_state})
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

    def snapshot():
        return {"params": lm_params_to_tree(params), "opt": opt_state}

    losses = []
    t0 = time.time()
    step = start_step
    try:
        for step in range(start_step, steps):
            batch = make_batch(cfg, shape, step, DataConfig(seed=seed),
                               dtype, device)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step % log_every == 0 or step == steps - 1:
                loss = float(metrics["loss"])
                losses.append(loss)
                print(f"[train] step {step} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
            if manager is not None and (step + 1) % ckpt_every == 0:
                manager.save_async(snapshot(), step + 1)
            if interrupted:
                manager.save(snapshot(), step + 1)
                print(f"[train] preempted at step {step + 1}; checkpoint "
                      f"flushed", flush=True)
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
                    help="cpu to run on the CPU; the card when unset")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = InputShape("cli", args.seq, args.batch, "train")
    run = train_loop(cfg, shape, steps=args.steps, ckpt_dir=args.ckpt,
                     device=args.device)
    print(json.dumps({"steps": run.steps, "final_loss": run.losses[-1],
                      "wall_s": run.wall_s}))


if __name__ == "__main__":
    main()

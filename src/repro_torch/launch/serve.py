"""Serving entry point of the LM zoo (the JAX package's ``launch/serve.py``):
greedy generation with a KV, MLA or SSM cache, on the cards of a mesh or
on one card.

    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b [--smoke]
    torchrun --nproc_per_node 8 -m repro_torch.launch.serve --arch gemma-2b

``generate`` runs every token, the prompt's included, through the decode
step (``make_decode_step``), as the reference does: that is right for
every cache family.  Under ``rules`` on a ``DeviceMesh`` the step runs
under the rules, the cache is laid out by ``cache_pspecs`` and the
prompts by ``batch_pspec``.  ``main`` draws the weights from a seeded
``torch.Generator`` on the card, in bfloat16 (the reference's draws
float32; deepseek-v2-lite-16b is 31.4 GB in bfloat16); launched by
``torchrun`` it serves on the host mesh under ``default_rules``, as the
reference's ``main`` does, the weights drawn module by module onto it.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..configs import get_config, smoke_config
from ..core.agent import resolve_device
from ..distributed.collectives import local_parallel
from ..distributed.sharding import (default_rules, distribute_tree,
                                    mesh_device, zeros_tree)
from ..models import transformer
from .mesh import join_world
from .steps import (_bind_rules, batch_pspec, cache_pspecs,
                    init_sharded_params, make_decode_step)


def generate(cfg, params, prompts: torch.Tensor, *, max_new_tokens: int = 16,
             max_len: Optional[int] = None, rules=None,
             dtype=torch.float32) -> Dict[str, object]:
    """prompts (B, S0) int -> {"tokens": (B, S0 + new), "decode_tps":
    float}, greedy, the cache of ``dtype`` on the prompts' device.  The
    prompt is fed token by token through the decode step; ``decode_tps``
    counts the new tokens over the wall time of their steps, after a
    ``torch.cuda.synchronize()`` on the card.  No graph is built, even on
    parameters that train: ``torch.inference_mode()``, or
    ``torch.no_grad()`` on a mesh (DTensor fails to view a parameter
    inside inference mode).

    ``rules`` on a ``DeviceMesh`` (every rank calls alike, the prompts
    the same on each, on this rank's device): the step runs under the
    rules, the cache is made as each rank's shards of ``cache_pspecs``,
    the prompts are laid out by ``batch_pspec``, and the tokens come back
    whole on every rank.  ``params`` are as the caller placed them
    (``init_sharded_params``, ``distribute_params``); plain ones count as
    replicated."""
    B, S0 = prompts.shape
    max_len = max_len or (S0 + max_new_tokens)
    device = prompts.device
    mesh = rules.mesh if rules is not None \
        and isinstance(rules.mesh, DeviceMesh) else None
    step = _bind_rules(make_decode_step(cfg), rules)
    with torch.no_grad() if mesh is not None else torch.inference_mode():
        if mesh is None:
            cache = transformer.init_cache(cfg, B, max_len, dtype,
                                           device=device)
            tokens = prompts
        else:
            shapes = transformer.init_cache(cfg, B, max_len, dtype,
                                            device="meta")
            cache = zeros_tree(shapes, cache_pspecs(shapes, rules), mesh)
            batch = {"tokens": prompts}
            tokens = distribute_tree(batch, batch_pspec(rules, batch),
                                     mesh)["tokens"]
        logits = None
        for pos in range(S0):
            logits, cache = step(params, {"tokens": tokens[:, pos:pos + 1]},
                                 cache, pos)
        _sync(device)
        t0 = time.perf_counter()
        for pos in range(S0, S0 + max_new_tokens):
            # On each rank's rows, the vocabulary gathered first (DTensor's
            # own argmax over a split dim fails in some torch releases).
            nxt = local_parallel(torch.argmax, (logits,), ((0,),), (0,),
                                 dim=-1).to(prompts.dtype)[:, None]
            tokens = torch.cat([tokens, nxt], dim=1)
            logits, cache = step(params, {"tokens": nxt}, cache, pos)
        _sync(device)
        dt = time.perf_counter() - t0
        if mesh is not None:
            tokens = tokens.full_tensor()
    return {"tokens": tokens,
            "decode_tps": B * max_new_tokens / max(dt, 1e-9)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (gloo under torchrun); the "
                         "card when unset")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = join_world(args.device)
    try:
        dtype = torch.bfloat16
        if mesh is None:
            device, rules = resolve_device(args.device), None
            params = transformer.init_params(
                cfg, generator=torch.Generator(device).manual_seed(0),
                device=device, dtype=dtype)
        else:
            device, rules = mesh_device(mesh), default_rules(mesh)
            params = init_sharded_params(
                cfg, rules, generator=torch.Generator(device).manual_seed(0),
                dtype=dtype)
        prompts = torch.randint(
            0, cfg.vocab_size, (args.batch, args.prompt_len),
            generator=torch.Generator(device).manual_seed(1), device=device)
        out = generate(cfg, params, prompts, max_new_tokens=args.new_tokens,
                       rules=rules, dtype=dtype)
        if mesh is None or dist.get_rank() == 0:
            print(json.dumps({
                "shape": list(out["tokens"].shape),
                "decode_tps": round(float(out["decode_tps"]), 2),
                "device": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else device.type)}))
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

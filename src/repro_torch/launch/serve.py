"""Serving entry point of the LM zoo (the JAX package's ``launch/serve.py``):
greedy generation with a KV, MLA or SSM cache on one card.

    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b [--smoke]

``generate`` runs every token, the prompt's included, through the decode
step (``make_decode_step``), as the reference does: that is right for
every cache family.  ``main`` draws the weights from a seeded
``torch.Generator`` on the card, in bfloat16 (the reference's draws
float32; deepseek-v2-lite-16b is 31.4 GB in bfloat16).  One card holds
the model: there is no mesh.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import torch

from ..configs import get_config, smoke_config
from ..core.agent import resolve_device
from ..models import transformer
from .steps import make_decode_step


@torch.inference_mode()
def generate(cfg, params, prompts: torch.Tensor, *, max_new_tokens: int = 16,
             max_len: Optional[int] = None,
             dtype=torch.float32) -> Dict[str, object]:
    """prompts (B, S0) int -> {"tokens": (B, S0 + new), "decode_tps":
    float}, greedy, the cache of ``dtype`` on the prompts' device.  The
    prompt is fed token by token through the decode step; ``decode_tps``
    counts the new tokens over the wall time of their steps, after a
    ``torch.cuda.synchronize()`` on the card.  Runs under
    ``torch.inference_mode()``: no graph, even on parameters that train."""
    B, S0 = prompts.shape
    max_len = max_len or (S0 + max_new_tokens)
    device = prompts.device
    cache = transformer.init_cache(cfg, B, max_len, dtype, device=device)
    step = make_decode_step(cfg)
    tokens = prompts
    logits = None
    for pos in range(S0):
        logits, cache = step(params, {"tokens": tokens[:, pos:pos + 1]},
                             cache, pos)
    _sync(device)
    t0 = time.perf_counter()
    for pos in range(S0, S0 + max_new_tokens):
        nxt = torch.argmax(logits, dim=-1).to(prompts.dtype)[:, None]
        tokens = torch.cat([tokens, nxt], dim=1)
        logits, cache = step(params, {"tokens": nxt}, cache, pos)
    _sync(device)
    dt = time.perf_counter() - t0
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
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device()
    dtype = torch.bfloat16
    params = transformer.init_params(
        cfg, generator=torch.Generator(device).manual_seed(0), device=device,
        dtype=dtype)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator(device).manual_seed(1),
                            device=device)
    out = generate(cfg, params, prompts, max_new_tokens=args.new_tokens,
                   dtype=dtype)
    print(json.dumps({"shape": list(out["tokens"].shape),
                      "decode_tps": round(float(out["decode_tps"]), 2),
                      "device": torch.cuda.get_device_name(device)}))


if __name__ == "__main__":
    main()

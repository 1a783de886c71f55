"""Learning-rate schedules (the JAX package's ``optim/schedule.py``):
linear warmup, then cosine, constant or rsqrt decay, in float32.

The schedule is read at the step count *before* the update, so the first
step's rate is 0 (warmup from 0), as in the reference.
"""
from __future__ import annotations

import math

import torch


def make_schedule(kind: str = "cosine", peak: float = 3e-4,
                  warmup_steps: int = 2000, total_steps: int = 100_000,
                  final_frac: float = 0.1):
    """``sched(step)`` -> the rate at ``step`` (an int or a tensor, such as
    an optimizer state's step on the card) as a float32 0-d tensor on the
    step's device, so reading it never waits on the card."""
    def sched(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        if kind == "constant":
            return warm
        if kind == "rsqrt":
            # A tensor numerator: ``float / tensor`` is a reciprocal and a
            # product in torch, which rounds otherwise than one division.
            num = torch.full_like(step, float(max(warmup_steps, 1.0)))
            return warm * torch.sqrt(num / torch.clamp(step,
                                                       min=warmup_steps))
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                    * frac))
        return warm * cos
    return sched

"""Learning-rate schedules (`repro/optim/schedules.py`): functions of the
step index (an int or a 0-d tensor) returning a 0-d f32 tensor."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        frac = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return lr * (final_frac + (1 - final_frac) * cos)

    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    base = cosine(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        w = torch.clamp(_f32(step) / max(warmup, 1), 0.0, 1.0)
        return torch.where(_f32(step) < warmup, _f32(lr) * w,
                           base(_f32(step) - warmup))

    return fn

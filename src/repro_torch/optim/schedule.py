"""Learning-rate schedules (pure functions of the step counter).

Port of the JAX package's ``optim/schedule.py``: each schedule maps a step
(an int or a 0-d tensor) to a 0-d f32 tensor on the step's device,
computed in f32 in the reference's order of operations.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(1.0, warmup_steps)
        frac = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        frac = torch.clamp(frac, 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, base_lr * cos)
    return lr


def constant(base_lr: float):
    def lr(step):
        return torch.full((), base_lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)
    return lr

"""LR schedules: pure functions of the step (port of
``repro.optim.schedule``).

``step`` is a 0-d integer tensor (the optimizer's counter, on its
device); the learning rate comes back as a 0-d float32 tensor on the same
device, computed in f32 as JAX computes it (divisions by a Python number
are IEEE divisions, ``core/solver.py::true_div``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.solver import true_div


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(true_div(step.float(), total_steps), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (min_frac + (1 - min_frac) * cos)

    return lr


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1),
                          min_frac)

    def lr(step: torch.Tensor) -> torch.Tensor:
        warm = true_div(base_lr * step.float(), max(warmup_steps, 1))
        return torch.where(step < warmup_steps, warm,
                           cos(step - warmup_steps))

    return lr

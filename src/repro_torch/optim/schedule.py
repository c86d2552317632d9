"""LR schedules (pure functions of the step counter). Port of
``repro/optim/schedule.py``, in float32 as the reference computes it."""
from __future__ import annotations

import math

import torch


def lr_at_step(step: torch.Tensor | int, *, base_lr: float,
               warmup_steps: int = 0, total_steps: int = 0,
               schedule: str = "cosine",
               min_ratio: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` as a float32 scalar tensor on the
    step's device (the CPU for a Python int)."""
    step = torch.as_tensor(step).to(torch.float32)
    lr = torch.tensor(base_lr, dtype=torch.float32, device=step.device)
    if warmup_steps > 0:
        lr = lr * torch.clamp_max((step + 1) / warmup_steps, 1.0)
    if schedule == "cosine" and total_steps > warmup_steps:
        frac = torch.clamp((step - warmup_steps)
                           / (total_steps - warmup_steps), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        lr = lr * (min_ratio + (1.0 - min_ratio) * cos)
    return lr

"""LR schedules: linear warmup + cosine decay (``repro/optim/schedule.py``).

At step 0 the warm-up factor is 0, so a run's first step moves no
parameter."""
from __future__ import annotations

import math

import torch

from repro_torch.config.base import OptimConfig


def lr_at(step, cfg: OptimConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), in float32 on
    ``step``'s device."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    total = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((s - cfg.warmup_steps) / total, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    floor = 0.1
    return cfg.lr * warm * (floor + (1 - floor) * cos)

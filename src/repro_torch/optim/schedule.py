"""Learning-rate schedules: each maps the optimizer's step (an integer
tensor) to an fp32 learning rate on the step's device, as
``repro.optim.schedule`` does."""

from __future__ import annotations

import math

import torch


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak_lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)
    return fn


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)

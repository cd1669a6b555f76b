"""Learning-rate schedules: float32 0-d tensors as functions of the step,
an int or an integer tensor (port of `repro.optim.schedules`)."""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step)


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_schedule(peak_lr: float, total_steps: int, *, final_frac: float = 0.1):
    def f(step):
        t = (_step(step) / max(1, total_steps)).to(torch.float32).clamp(0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return peak_lr * (final_frac + (1 - final_frac) * cos)

    return f


def linear_warmup_cosine(
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    *,
    final_frac: float = 0.1,
):
    cos = cosine_schedule(
        peak_lr, max(1, total_steps - warmup_steps), final_frac=final_frac
    )

    def f(step):
        s = _step(step)
        warm = peak_lr * torch.clamp(
            ((s + 1) / max(1, warmup_steps)).to(torch.float32), max=1.0
        )
        return torch.where(s < warmup_steps, warm, cos(s - warmup_steps))

    return f

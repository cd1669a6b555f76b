"""Optimizers as functions on trees of tensors (port of `repro.optim`)."""

from repro_torch.optim.clip import (
    clip_by_global_norm,
    clip_by_global_norm_,
    global_norm,
)
from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    adamw,
    apply_updates,
    sgd,
)
from repro_torch.optim.schedules import (
    constant_schedule,
    cosine_schedule,
    linear_warmup_cosine,
)

__all__ = [
    "Optimizer",
    "adam",
    "adamw",
    "apply_updates",
    "sgd",
    "constant_schedule",
    "cosine_schedule",
    "linear_warmup_cosine",
    "clip_by_global_norm",
    "clip_by_global_norm_",
    "global_norm",
]

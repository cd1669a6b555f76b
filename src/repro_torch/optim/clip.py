"""Gradient clipping by global norm (port of `repro.optim.clip`)."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch._tree import leaves, tree_map


@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(
        sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree))
    )


@torch.no_grad()
def clip_by_global_norm(tree: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Returns (clipped_tree, pre_clip_norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: (x * scale).to(x.dtype), tree), norm


@torch.no_grad()
def clip_by_global_norm_(tree: Any, max_norm: float, *,
                         norm: torch.Tensor | None = None) -> torch.Tensor:
    """`clip_by_global_norm` written into `tree`'s leaves in place (the
    same products, bit for bit); returns the pre-clip norm. A `norm`
    given (one reduced over shards) stands for `global_norm(tree)`."""
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for x in leaves(tree):
        x.mul_(scale)
    return norm

"""Micro-batch gradient accumulation (port of `repro.dist.accumulate`).

`accumulate_grads` splits the global batch into `n_steps` leading-dim
chunks, runs `grad_fn` on each in turn, sums the gradients and averages
them at the end. Every loss in the repo is a mean over batch elements, so
the mean of the micro-batch gradients equals the full-batch gradient up
to summation order. The reference's `lax.scan` is a Python loop here:
PyTorch runs eagerly, and each chunk's activations are freed when its
gradients are taken.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch._tree import tree_map


def accumulate_grads(
    grad_fn: Callable[[Any, Any], tuple[Any, dict]],
    params: Any,
    batch: Any,
    n_steps: int,
) -> tuple[Any, dict]:
    """Run `grad_fn(params, micro_batch) -> (grads, metrics)` over
    `n_steps` leading-dim chunks of `batch`; returns the mean gradients
    and the mean of each metric. Raises ValueError when the batch does not
    divide into `n_steps` chunks."""
    if n_steps is None or n_steps <= 1:
        return grad_fn(params, batch)

    def split(x):
        b = x.shape[0]
        if b % n_steps:
            raise ValueError(f"batch dim {b} not divisible by n_steps={n_steps}")
        return x.reshape(n_steps, b // n_steps, *x.shape[1:])

    micro = tree_map(split, batch)
    g_sum = tree_map(torch.zeros_like, params)
    metrics = []
    for i in range(n_steps):
        g, m = grad_fn(params, tree_map(lambda x: x[i], micro))
        g_sum = tree_map(torch.add, g_sum, g)
        metrics.append(m)
    grads = tree_map(lambda g: g / n_steps, g_sum)
    stacked = tree_map(lambda *ms: torch.stack(ms).mean(dim=0), *metrics)
    return grads, stacked

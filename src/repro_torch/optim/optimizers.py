"""SGD / Adam / AdamW as functions on trees of tensors (port of
`repro.optim.optimizers`).

Each optimizer is an `Optimizer(init, update)` pair:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

The state is a plain dict mirroring the params leaf for leaf (`{"m", "v"}`
for Adam, `{"mu"}` for SGD), so a checkpoint can save it as it is; `step`
is passed in, not carried; the learning rate is a schedule of the step.
`torch.optim` is not used: its state is hidden inside the optimizer object.
Updates are computed under `torch.no_grad()` into new tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch._tree import map_with_path, tree_map

Schedule = Callable[[Any], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def sgd(lr, *, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        if momentum == 0.0:
            return {"mu": None}
        return {"mu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = sched(step)
        if momentum == 0.0:
            return tree_map(lambda g: -lr_t * g, grads), state
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        if nesterov:
            upd = tree_map(lambda m, g: -lr_t * (momentum * m + g), mu, grads)
        else:
            upd = tree_map(lambda m: -lr_t * m, mu)
        return upd, {"mu": mu}

    return Optimizer(init, update)


def adam(
    lr, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
) -> Optimizer:
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def adamw(
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    mask: Optional[Callable[[tuple], bool]] = None,
) -> Optimizer:
    """AdamW with bias correction; `mask(path)` — `path` the tuple of dict
    keys to a parameter — gates weight decay (every parameter when None)."""
    sched = _as_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = sched(step)
        # bias corrections in float32, as the reference computes b**t
        t = torch.as_tensor(step).to(torch.float32) + 1.0
        c1 = 1.0 - b1**t
        c2 = 1.0 - b2**t
        m = tree_map(
            lambda mm, g: b1 * mm + (1 - b1) * g.to(torch.float32),
            state["m"], grads,
        )
        v = tree_map(
            lambda vv, g: b2 * vv + (1 - b2) * torch.square(g.to(torch.float32)),
            state["v"], grads,
        )

        def upd(path, mm, vv, p):
            step_dir = (mm / c1) / (torch.sqrt(vv / c2) + eps)
            if weight_decay != 0.0 and (mask is None or mask(path)):
                step_dir = step_dir + weight_decay * p.to(torch.float32)
            return (-lr_t * step_dir).to(p.dtype)

        return map_with_path(upd, m, v, params), {"m": m, "v": v}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)

"""SGD / Adam / AdamW as functions on trees of tensors (port of
`repro.optim.optimizers`).

Each optimizer is an `Optimizer(init, update, update_)` triple:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

The state is a plain dict mirroring the params leaf for leaf (`{"m", "v"}`
for Adam, `{"mu"}` for SGD), so a checkpoint can save it as it is; `step`
is passed in, not carried; the learning rate is a schedule of the step.
`torch.optim` is not used: its state is hidden inside the optimizer object.
`update` computes under `torch.no_grad()` into new tensors.

`update_(grads, state, params, step)` is the same update written into
`params` and `state` in place, leaf by leaf — the port's counterpart of
the reference's donated train step (`trainer.make_train_step(...,
donate=True)`). It consumes `grads` as scratch and allocates at most one
leaf-sized temporary at a time. Every in-place op keeps the functional
order of operations, so the result is the functional update's bit for
bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch._tree import leaves, map_with_path, tree_map

Schedule = Callable[[Any], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]
    update_: Callable[..., None]


def _as_schedule(lr) -> Schedule:
    """A constant `lr` as the float32 value a 0-d float32 tensor of it
    holds, kept as a Python float: every use multiplies by it as by that
    tensor, and the step makes no tensor from host data."""
    if callable(lr):
        return lr
    lr32 = float(np.float32(lr))
    return lambda step: lr32


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

    @torch.no_grad()
    def update_(grads, state, params, step):
        lr_t = sched(step)
        mus = [None] * len(leaves(params)) if momentum == 0.0 else leaves(
            state["mu"])
        for g, m, p in zip(leaves(grads), mus, leaves(params)):
            if m is not None:
                m.mul_(momentum).add_(g)  # momentum * m + g
                if nesterov:
                    g.add_(m * momentum)  # (momentum * mu + g) into g
                else:
                    g.copy_(m)
            p.add_(g.mul_(-lr_t).to(p.dtype))

    return Optimizer(init, update, update_)


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

    def corrections(step):
        # bias corrections in float32, as the reference computes b**t
        t = torch.as_tensor(step).to(torch.float32) + 1.0
        return 1.0 - b1**t, 1.0 - b2**t

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = sched(step)
        c1, c2 = corrections(step)
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

    @torch.no_grad()
    def update_(grads, state, params, step):
        lr_t = sched(step)
        c1, c2 = corrections(step)

        def one(path, g, mm, vv, p):
            g = g.to(torch.float32)
            tmp = g * (1 - b1)
            mm.mul_(b1).add_(tmp)  # b1 * m + (1 - b1) * g
            torch.square(g, out=tmp).mul_(1 - b2)
            vv.mul_(b2).add_(tmp)  # b2 * v + (1 - b2) * g^2
            # g is scratch from here: the denominator, then the decay term
            torch.div(vv, c2, out=g).sqrt_().add_(eps)
            torch.div(mm, c1, out=tmp).div_(g)
            if weight_decay != 0.0 and (mask is None or mask(path)):
                tmp.add_(torch.mul(p.to(torch.float32), weight_decay, out=g))
            p.add_(tmp.mul_(-lr_t).to(p.dtype))

        map_with_path(one, grads, state["m"], state["v"], params)

    return Optimizer(init, update, update_)


@torch.no_grad()
def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)

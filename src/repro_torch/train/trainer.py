"""Trainer: the train step (port of `repro.train.trainer`'s
`init_state` and `make_train_step`).

`make_train_step(loss_fn, optimizer, ...)` returns a
(state, batch) -> (state, metrics) function with micro-batch gradient
accumulation when n_micro > 1, global-norm clipping, and the optimizer's
update with its schedule evaluated at state["step"]. The state is a plain
dict {"params", "opt", "step"}, as in the reference, so a checkpoint can
save it as it is. The step runs eagerly: no `jit`, no `torch.compile`.

Gradients come from `torch.autograd.grad` on leaf copies of the params,
not from `torch.func`: the straight-through `autograd.Function`s of the
SPE constraints have no `setup_context`, which `torch.func` needs.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import _device
from repro_torch._tree import leaves, tree_map
from repro_torch.dist.accumulate import accumulate_grads
from repro_torch.optim import clip_by_global_norm, global_norm
from repro_torch.optim.optimizers import Optimizer, apply_updates


def init_state(
    params: Any, optimizer: Optimizer, *, device: _device.DeviceLike = None
) -> dict:
    """{"params", "opt", "step"} with the params on `device` (`None` means
    the CUDA card; raises without one) and `step` a 0-d int32 tensor."""
    dev = _device.resolve(device)
    params = tree_map(lambda p: p.detach().to(dev), params)
    return {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def make_train_step(
    loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]],
    optimizer: Optimizer,
    *,
    clip_norm: float = 1.0,
    n_micro: int = 1,
) -> Callable[[dict, Any], tuple[dict, dict]]:
    def grad_fn(params, mb):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, mb)
            grads = torch.autograd.grad(loss, leaves(live))
        it = iter(grads)
        return (
            tree_map(lambda _: next(it), live),
            tree_map(torch.Tensor.detach, metrics),
        )

    def train_step(state: dict, batch: Any) -> tuple[dict, dict]:
        grads, metrics = accumulate_grads(
            grad_fn, state["params"], batch, n_micro
        )
        if clip_norm:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = global_norm(grads)
        updates, opt = optimizer.update(
            grads, state["opt"], state["params"], state["step"]
        )
        new_state = {
            "params": apply_updates(state["params"], updates),
            "opt": opt,
            "step": state["step"] + 1,
        }
        return new_state, {**metrics, "grad_norm": gnorm}

    return train_step

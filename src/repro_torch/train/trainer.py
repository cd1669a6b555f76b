"""Trainer: the train step (port of `repro.train.trainer`'s
`init_state` and `make_train_step`).

`make_train_step(loss_fn, optimizer, ...)` returns a
(state, batch) -> (state, metrics) function with micro-batch gradient
accumulation when n_micro > 1, global-norm clipping, and the optimizer's
update with its schedule evaluated at state["step"]. The state is a plain
dict {"params", "opt", "step"}, as in the reference, so a checkpoint can
save it as it is. The step runs eagerly: no `jit`, no `torch.compile`.

`donate=True` is the port's counterpart of the reference's
`jax.jit(step, donate_argnums=(0,))`: the step clips the gradients and
writes the update into `state["params"]`, `state["opt"]` and
`state["step"]` in place, leaf by leaf (`Optimizer.update_`), and returns
that same dict. Beyond the state and the gradients it holds one leaf's
worth of temporaries at a time, where the functional step holds old and
new moments, the updates and the new params at once (about twice the
state: what keeps recurrentgemma-2b's float32 AdamW state on one card).
As after the reference's donation, a donated state is not valid after a
step that raised: restore it from a checkpoint (`fault.run_training`
does).

Gradients come from `torch.autograd.grad` on leaf copies of the params,
not from `torch.func`: the straight-through `autograd.Function`s of the
SPE constraints have no `setup_context`, which `torch.func` needs. A
parameter the loss does not use gets a zero gradient, as `jax.grad`
gives.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import _device
from repro_torch._tree import leaves, tree_map
from repro_torch.dist.accumulate import accumulate_grads
from repro_torch.optim import (
    clip_by_global_norm,
    clip_by_global_norm_,
    global_norm,
)
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


def _own_storage(grads: Any) -> Any:
    """`grads` with every leaf contiguous in storage no other leaf shares
    (autograd may hand one buffer to two parameters, or an expanded view
    to a summed one), so that the in-place update can use each as
    scratch."""
    seen = set()

    def one(g):
        ptr = g.untyped_storage().data_ptr()
        if ptr in seen:
            return g.clone()
        seen.add(ptr)
        return g.contiguous()

    return tree_map(one, grads)


def make_train_step(
    loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]],
    optimizer: Optimizer,
    *,
    clip_norm: float = 1.0,
    n_micro: int = 1,
    donate: bool = False,
) -> Callable[[dict, Any], tuple[dict, dict]]:
    def grad_fn(params, mb):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, mb)
            grads = torch.autograd.grad(loss, leaves(live), allow_unused=True,
                                        materialize_grads=True)
        it = iter(grads)
        return (
            tree_map(lambda _: next(it), live),
            tree_map(torch.Tensor.detach, metrics),
        )

    def train_step(state: dict, batch: Any) -> tuple[dict, dict]:
        grads, metrics = accumulate_grads(
            grad_fn, state["params"], batch, n_micro
        )
        if donate:
            grads = _own_storage(grads)
            gnorm = (clip_by_global_norm_(grads, clip_norm) if clip_norm
                     else global_norm(grads))
            optimizer.update_(grads, state["opt"], state["params"],
                              state["step"])
            state["step"].add_(1)
            return state, {**metrics, "grad_norm": gnorm}
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

"""Trainer: the train step and the compressed multi-pod step (port of
`repro.train.trainer`).

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

Multi-pod (`make_multipod_train_step`, `make_dp_step_compressed`): one
rank a pod on a ("pod", "data", "model") `DeviceMesh` with data = model
= 1; every rank draws the same global batch and takes its pod's rows,
reduces its gradients over the pod group through `dist.compression`, and
applies the same update, so the params stay equal on every rank. The
per-pod error-feedback buffers ride in state["err"] (`init_dp_err`): each
rank holds its own (1, *leaf) block, and a checkpoint gathers them into
the reference's (n_pod, *leaf) layout (`checkpoint.save(...,
shardings=)`). The in-pod placements over data and model (FSDP, TP) are
ROADMAP.md queue 1 item 8b.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import _device, obs
from repro_torch._tree import leaves, tree_map
from repro_torch.dist import compression as C
from repro_torch.dist import sharding as shd
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


def _grad_fn(loss_fn: Callable) -> Callable:
    """(params, batch) -> (grads, metrics) of `loss_fn`, by autograd on
    leaf copies of the params."""
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

    return grad_fn


def make_train_step(
    loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]],
    optimizer: Optimizer,
    *,
    clip_norm: float = 1.0,
    n_micro: int = 1,
    donate: bool = False,
) -> Callable[[dict, Any], tuple[dict, dict]]:
    grad_fn = _grad_fn(loss_fn)

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


def state_specs(state_shapes: Any, cfg, mesh) -> dict:
    """Specs for a {"params", "opt", "step"} state tree: opt moments
    mirror the param specs (ZeRO-1); step is replicated."""
    p_specs = shd.param_specs(state_shapes["params"], cfg, mesh)
    o_specs = {
        k: None if sub is None else shd.param_specs(sub, cfg, mesh)
        for k, sub in state_shapes["opt"].items()
    }
    return {"params": p_specs, "opt": o_specs, "step": ()}


# ---------------------------------------------------------------------------
# Data parallelism over the pod axis with compressed gradients
# ---------------------------------------------------------------------------

_SCHEMES = ("gather", "two_stage")


def init_dp_err(
    params: Any,
    mesh,
    *,
    axis: str = "pod",
    scheme: str = "gather",
    compress: bool = True,
) -> dict:
    """Zero error-feedback buffers for the compressed DP steps: this
    rank's (1, *leaf) block of the reference's (n_pods, *leaf) arrays,
    which exist whole only in a checkpoint (`checkpoint.save(...,
    shardings=)` gathers them; restoring on another pod count raises).

      gather:    {"s1": tree[(1, *leaf.shape)]}
      two_stage: {"s1": tree[(1, *leaf.shape)],
                  "s2": tree[(1, ceil(|leaf|/n))]}
      compress=False: {} (the uncompressed path is stateless)
    """
    if not compress:
        return {}
    if scheme not in _SCHEMES:
        raise ValueError(f"scheme {scheme!r}: expected one of {_SCHEMES}")
    n = shd.axis_sizes(mesh)[axis]

    def zeros(p, shape):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    err = {"s1": tree_map(lambda p: zeros(p, (1,) + tuple(p.shape)), params)}
    if scheme == "two_stage":
        err["s2"] = tree_map(
            lambda p: zeros(p, (1, C.two_stage_shard_len(p.numel() or 1, n))),
            params,
        )
    return err


def _reduce_grads(grads: Any, err: dict, group, *, compress: bool,
                  scheme: str) -> None:
    """Scheme dispatch shared by the DP steps, in place: `grads` receive
    the mean over `group`, the (1, *leaf) error blocks their new
    residuals."""
    if not compress:
        C.uncompressed_psum_mean_(grads, group)
        return
    sq = lambda t: tree_map(lambda x: x[0], t)  # noqa: E731
    if scheme == "gather":
        C.compressed_psum_mean_(grads, sq(err["s1"]), group)
    elif scheme == "two_stage":
        C.two_stage_psum_mean_(grads, sq(err["s1"]), sq(err["s2"]), group)
    else:
        raise ValueError(f"scheme {scheme!r}: expected one of {_SCHEMES}")


def _pmean(metrics: dict, group) -> dict:
    """Each metric's mean over the ranks of `group` (the reference's
    pmean), in one all-reduce."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].to(torch.float32).reshape(())
                        for k in keys])
    dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=group)
    vals = vals / dist.get_world_size(group)
    return {k: vals[i] for i, k in enumerate(keys)}


def make_dp_step_compressed(
    loss_fn: Callable,
    optimizer: Optimizer,
    mesh,
    *,
    axis: str = "pod",
    clip_norm: float = 1.0,
    compress: bool = True,
    scheme: str = "gather",
    n_micro: int = 1,
):
    """Data-parallel train step over the mesh axis `axis` with quantized
    error-feedback gradient reduction (`dist.compression`). Params
    replicated over `axis`; the batch sharded: every rank is handed the
    same global batch (B, ...) and takes the rows [p·B/n, (p+1)·B/n) of
    its coordinate p on `axis` (B not divisible by n raises). State is
    {"params", "opt", "step", "err"} with `err` from `init_dp_err`.

    `scheme` picks the wire layout: "gather" (full-leaf int8 all-gather,
    (8/n)x egress) or "two_stage" (quantized reduce-scatter + all-gather,
    n-independent ~4x). `compress=False` runs the finite-guarded f32 mean
    (stateless, err stays {}). Then clip, update, and the metrics
    averaged over the pods; without clipping `grad_norm` is the norm of
    the mean gradient.

    The step is donated, as the reference's jitted steps are: it writes
    into `state` in place (the error buffers receive the residuals, the
    gradient buffers the mean, `Optimizer.update_` the update), as the
    single-device `make_train_step(donate=True)`, and returns it. Spans:
    `train/grads`, `train/reduce`, `train/update` (each waits for the
    card when telemetry is on).
    """
    if compress and scheme not in _SCHEMES:
        raise ValueError(f"scheme {scheme!r}: expected one of {_SCHEMES}")
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    pod = mesh.get_local_rank(axis)
    if dist.get_rank(group) != pod:
        # the two-stage all-to-all sends row j to the j-th rank of the
        # group: that rank must be pod j
        raise RuntimeError(
            f"rank {dist.get_rank()}: position {dist.get_rank(group)} in "
            f"the {axis!r} group differs from its coordinate {pod}"
        )
    grad_fn = _grad_fn(loss_fn)

    def step(state: dict, batch: Any) -> tuple[dict, dict]:
        tel = obs.get()
        leading = leaves(batch)[0].shape[0]
        if leading % n:
            raise ValueError(
                f"multi-pod batch {leading} not divisible by {n} pods"
            )
        rows = leading // n
        local = tree_map(lambda x: x[pod * rows:(pod + 1) * rows], batch)
        with tel.span("train/grads", cat="train"):
            grads, metrics = accumulate_grads(grad_fn, state["params"],
                                              local, n_micro)
            grads = _own_storage(grads)
            tel.block(leaves(grads)[:1])  # one stream: one wait
        with tel.span("train/reduce", cat="train"):
            _reduce_grads(grads, state["err"], group, compress=compress,
                          scheme=scheme)
            tel.block(leaves(grads)[:1])
        with tel.span("train/update", cat="train"):
            gnorm = (clip_by_global_norm_(grads, clip_norm) if clip_norm
                     else global_norm(grads))
            optimizer.update_(grads, state["opt"], state["params"],
                              state["step"])
            state["step"].add_(1)
            tel.block(gnorm)
        return state, {**_pmean(metrics, group), "grad_norm": gnorm}

    return step


def make_multipod_train_step(
    loss_fn: Callable,
    optimizer: Optimizer,
    cfg,
    mesh,
    state_shapes: Any = None,
    *,
    scheme: str = "gather",
    compress: bool = True,
    clip_norm: float = 1.0,
    n_micro: int = 1,
):
    """Compressed multi-pod data-parallel training over a
    ("pod", "data", "model") mesh with data = model = 1. Three stages a
    step, as the reference's:

      A. this pod's gradients over its rows of the global batch, with
         `accumulate_grads` over `n_micro` micro-batches;
      B. the cross-pod reduction through the selected
         `dist.compression` scheme over the pod group;
      C. clip and update (donated: `clip_by_global_norm_`,
         `Optimizer.update_`); the metrics averaged over the pods.

    Returns (step, state_shardings): `step(state, batch) -> (state,
    metrics)` is what `fault.run_training` drives; `state_shardings`
    (`NamedSharding`s mirroring `state_shapes`, a state tree including
    "err"; None without it) tells `checkpoint.save` / `restore` that the
    error buffers are per-pod blocks ("pod" on their leading dim) and the
    rest replicated.

    An in-pod axis larger than 1 raises: placing the params and the
    batch over data and model (FSDP, TP) is ROADMAP.md queue 1 item 8b.
    """
    sizes = shd.axis_sizes(mesh)
    if "pod" not in sizes:
        raise ValueError(
            f"make_multipod_train_step needs a 'pod' mesh axis, got "
            f"{tuple(sizes)} (launch.mesh.make_multipod_mesh)"
        )
    in_pod = sizes.get("data", 1) * sizes.get("model", 1)
    if in_pod > 1:
        raise ValueError(
            f"multi-pod with in-pod data x model = {in_pod}: the placement "
            f"of parameters over 'data' and 'model' is not ported yet "
            f"(ROADMAP.md queue 1 item 8b); use PxD with D = 1"
        )
    if compress and scheme not in _SCHEMES:
        raise ValueError(f"scheme {scheme!r}: expected one of {_SCHEMES}")
    shardings = None
    if state_shapes is not None:
        core = {k: state_shapes[k] for k in ("params", "opt", "step")}
        specs = {**state_specs(core, cfg, mesh),
                 "err": tree_map(lambda _: ("pod",), state_shapes["err"])}
        shardings = shd.named(specs, mesh)
    step = make_dp_step_compressed(
        loss_fn, optimizer, mesh, axis="pod", clip_norm=clip_norm,
        compress=compress, scheme=scheme, n_micro=n_micro,
    )
    return step, shardings

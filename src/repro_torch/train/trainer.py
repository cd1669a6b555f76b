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

Over `data` and `model` (`make_sharded_train_step` on a ("data",
"model") mesh, and stage A of `make_multipod_train_step`): the params and
their moments are placed by `dist.sharding.param_specs` (FSDP over
`data`, TP over `model`; the moments mirror them: ZeRO-1), each rank
holding its blocks (`dist.sharding.place`). Every rank is handed the
same global batch and takes its rows (its coordinate over the axes
`dist.sharding.data_axes` gives: ("pod", "data"), and `model` too for
whisper's pure-DP profile); the loss runs inside
`dist.sharding.activation_context`, whose collectives carry their
adjoints (stated in `dist.sharding`), so the gradients come out in each
rank's blocks: summed over `data` by the FSDP reduce-scatter for the
leaves `data` splits, all-reduced over `data` for the others (and over
`model` where it carries rows), then divided by the ranks the rows span.
MoE's experts split their hidden axis over `model` and RWKV-6 runs its
local heads (`models.moe`, `models.rwkv6`); under the paper's QAT a
row-parallel weight's per-column scales are reduced over `model`
(`core.spe.spe_train_weight`), and a row block must hold whole 16:8
prune groups (`state_specs` raises `ShardingGuardError`, naming the
leaf). The sharded step reduces the global norm over the shards and
updates the blocks in place.

Multi-pod (`make_multipod_train_step`): one code path for every PxDxM,
1x1x1 included (its collectives bypassed at world 1). Stage A as above
over this pod's rows, its mean gradients then all-gathered into whole
leaves replicated over `data` and `model` (so the error buffers' shapes
depend on the pod count alone, and checkpoints move across in-pod
layouts); stage B reduces them over this rank's pod group through
`dist.compression`; stage C clips the whole mean and updates each rank's
blocks (ZeRO-1). The per-pod error-feedback buffers ride in state["err"]
(`init_dp_err`): each rank holds its pod's (1, *leaf) block, and a
checkpoint gathers them into the reference's (n_pod, *leaf) layout
(`checkpoint.save(..., shardings=)`).
"""

from __future__ import annotations

import math
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


# Declared collective envelope of the train-step cells, checked by the
# `repro_torch.analysis` cell audit (the reference's): what it catches is a
# per-parameter resharding emitting thousands of collectives a step, not
# an exact count a scheme.
_TRAIN_COMM_ENVELOPE = {
    "all-reduce": 512,
    "all-gather": 512,
    "reduce-scatter": 512,
    "collective-permute": 512,
    "all-to-all": 512,
}


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
        storage = g.untyped_storage()._cdata  # a fake tensor's data_ptr is 0
        if storage in seen:
            return g.clone()
        seen.add(storage)
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
    mirror the param specs (ZeRO-1); step is replicated. Under the paper's
    16:8 QAT a row-parallel weight's block must hold whole prune groups
    (`dist.sharding.check_row_groups`, `ShardingGuardError`)."""
    p_specs = shd.param_specs(state_shapes["params"], cfg, mesh)
    if cfg.spe_sparse:
        shd.check_row_groups(
            state_shapes["params"], p_specs, mesh,
            lambda node: cfg.spe_group if "w" in node else None,
            f"{cfg.name}'s 16:8 QAT")
    o_specs = {
        k: None if sub is None else shd.param_specs(sub, cfg, mesh)
        for k, sub in state_shapes["opt"].items()
    }
    return {"params": p_specs, "opt": o_specs, "step": ()}


def _split(spec, axis: str, mesh) -> bool:
    return any(axis in shd._names(e) for e in spec) and \
        shd.axis_sizes(mesh).get(axis, 1) > 1


def _rows(batch: Any, cfg, mesh, *, replicate_indivisible: bool = False
          ) -> Any:
    """This rank's rows of the global batch: its coordinate over the
    mesh's axes that carry rows (`dist.sharding.data_axes`: ("pod",
    "data"), and "model" too for a pure-DP profile), outer first (B not
    divisible raises). With `replicate_indivisible` such a batch runs
    whole on every rank instead, as `dist.sharding.batch_specs` leaves it
    unsharded (the reference's GSPMD step then computes it replicated):
    the dry-run's choice, to count the reference's cells."""
    axes = shd.data_axes(cfg, mesh)
    n = math.prod(shd.axis_sizes(mesh)[a] for a in axes)
    leading = leaves(batch)[0].shape[0]
    if leading % n and not replicate_indivisible:
        raise ValueError(
            f"batch {leading} not divisible by the {n} ranks of {axes}")
    if n == 1 or leading % n:
        return batch
    rows = leading // n
    lo = shd._coordinate(axes, mesh) * rows
    return tree_map(lambda x: x[lo:lo + rows], batch)


def _all_reduce_many_(xs: list, group) -> None:
    """Each of the float tensors `xs` summed over `group` in place, in one
    all-reduce of their bytes packed as float32."""
    if not xs:
        return
    buf = shd.all_reduce(torch.cat([x.reshape(-1).to(torch.float32)
                                    for x in xs]), group)
    off = 0
    for x in xs:
        x.copy_(buf[off:off + x.numel()].view(x.shape))
        off += x.numel()


def _block_grads(grad_fn, params, batch, cfg, mesh, p_specs, n_micro):
    """Stage A's gradients on this rank's rows, in this rank's blocks of
    `p_specs`: the loss in the activation context (the FSDP leaves'
    gradients reduce-scattered over `data` by `gather_block`'s backward),
    the leaves `data` does not split all-reduced over `data` (and every
    leaf over `model` where a pure-DP profile puts rows there), every leaf
    divided by the ranks the rows span, the metrics averaged over them."""
    with shd.activation_context(cfg, mesh, specs=p_specs):
        grads, metrics = accumulate_grads(grad_fn, params, batch, n_micro)
    grads = _own_storage(grads)
    groups = shd.mesh_groups(mesh)
    row_groups = [(groups.data, groups.n_data,
                   [g for g, spec in _with_specs(grads, p_specs)
                    if not _split(spec, "data", mesh)])]
    if not cfg.use_tp:
        row_groups.append((groups.model, groups.tp, leaves(grads)))
    n_rows = 1
    for group, n, xs in row_groups:
        if n > 1:
            _all_reduce_many_(xs, group)
            metrics = _pmean(metrics, group)
            n_rows *= n
    if n_rows > 1:
        for g in leaves(grads):
            g.div_(n_rows)
    return grads, metrics


def _with_specs(tree: Any, specs: Any) -> list:
    """(leaf, spec) pairs of a tree and its spec tree."""
    out: list = []
    tree_map(lambda x, spec: out.append((x, spec)), tree, specs)
    return out


def _sharded_norm(grads: Any, p_specs: Any, mesh) -> torch.Tensor:
    """The global norm of gradients held in blocks: each block's squares
    counted on the ranks at coordinate 0 of the axes its spec does not
    split, the sum all-reduced over `data` and `model`."""
    groups = shd.mesh_groups(mesh)
    sq = torch.zeros((), dtype=torch.float32, device=leaves(grads)[0].device)
    for g, spec in _with_specs(grads, p_specs):
        if ((groups.data_rank and not _split(spec, "data", mesh))
                or (groups.model_rank and not _split(spec, "model", mesh))):
            continue
        sq = sq + torch.sum(torch.square(g.to(torch.float32)))
    for group in (groups.data, groups.model):
        if group is not None:
            sq = shd.all_reduce(sq, group)
    return torch.sqrt(sq)


def _blocks(grads: Any, p_specs: Any, mesh) -> Any:
    """This rank's block of each whole gradient under `p_specs` (ZeRO-1:
    the update's part), contiguous; the leaf itself where unsplit."""
    return tree_map(
        lambda g, spec: g if shd.spec_shard_factor(spec, mesh) == 1
        else shd.shard_local(g, spec, mesh).contiguous(), grads, p_specs)


def make_sharded_train_step(
    loss_fn: Callable,
    optimizer: Optimizer,
    cfg,
    mesh,
    state_shapes: Any,
    batch_shapes: Any,
    *,
    clip_norm: float = 1.0,
    n_micro: int = 1,
    donate: bool = True,
    replicate_indivisible: bool = False,
):
    """One in-pod train step on a ("data", "model") `DeviceMesh` with the
    params and moments placed by `state_specs` (FSDP over `data`, TP over
    `model`, the moments mirroring the params: ZeRO-1). Returns (step,
    state_shardings, batch_shardings): the `NamedSharding` trees of
    `state_shapes` (global shapes: tensors, or "meta" ones) and of
    `batch_shapes`.

    `step(state, batch) -> (state, metrics)` takes a state of this rank's
    blocks (`dist.sharding.place` under `state_shardings`' specs) and the
    global batch, of which it runs this rank's `data` rows; the gradients
    stay in each rank's blocks (the mean over `data`), the global norm is
    reduced over the shards (so clipping equals the replicated step's),
    and `Optimizer.update_` writes the update into the local blocks of
    params and moments (`donate=False` updates a copy, leaving the
    caller's state valid). The metrics are the mean over `data`. A batch
    the `data` ranks do not divide raises, or with `replicate_indivisible`
    (the dry-run's) runs whole on every rank. Span: `train/grads`,
    `train/update`.
    """
    s_specs = state_specs(state_shapes, cfg, mesh)
    b_specs = shd.batch_specs(batch_shapes, cfg, mesh)
    p_specs = s_specs["params"]
    grad_fn = _grad_fn(loss_fn)

    def step(state: dict, batch: Any) -> tuple[dict, dict]:
        tel = obs.get()
        with tel.span("train/grads", cat="train"):
            grads, metrics = _block_grads(
                grad_fn, state["params"],
                _rows(batch, cfg, mesh,
                      replicate_indivisible=replicate_indivisible),
                cfg, mesh, p_specs, n_micro)
            tel.block(leaves(grads)[:1])
        with tel.span("train/update", cat="train"):
            gnorm = _sharded_norm(grads, p_specs, mesh)
            if clip_norm:
                clip_by_global_norm_(grads, clip_norm, norm=gnorm)
            if not donate:
                state = tree_map(lambda x: None if x is None else x.clone(),
                                 state)
            optimizer.update_(grads, state["opt"], state["params"],
                              state["step"])
            state["step"].add_(1)
            tel.block(gnorm)
        return state, {**metrics, "grad_norm": gnorm}

    step = obs.get().probe.track(
        "train.step", step, budget=_TRAIN_COMM_ENVELOPE,
        donate=(0,) if donate else (), sharded_outputs=True, mesh=mesh,
        out_specs=[s_specs])
    return step, shd.named(s_specs, mesh), shd.named(b_specs, mesh)


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
    C.count_call("all_reduce", vals)
    dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=group)
    vals = vals / dist.get_world_size(group)
    return {k: vals[i] for i, k in enumerate(keys)}


def make_multipod_train_step(
    loss_fn: Callable,
    optimizer: Optimizer,
    cfg,
    mesh,
    state_shapes: Any,
    *,
    scheme: str = "gather",
    compress: bool = True,
    clip_norm: float = 1.0,
    n_micro: int = 1,
    replicate_indivisible: bool = False,
):
    """Compressed multi-pod training over a ("pod", "data", "model")
    mesh, one rank a device, for every PxDxM. Three stages a step, as the
    reference's:

      A. this rank's rows of its pod's part of the global batch (B must
         divide by P·D), with the params in its blocks under
         `param_specs` (FSDP over `data`, TP over `model`): the gradients
         in its blocks, the mean over `data` (`make_sharded_train_step`'s
         stage, with `accumulate_grads` over `n_micro` micro-batches),
         then all-gathered into whole leaves replicated over `data` and
         `model`, as the reference's stage A exits;
      B. the cross-pod reduction of the whole leaves through the selected
         `dist.compression` scheme over this rank's pod group;
      C. clip on the whole mean gradients, then the ZeRO-1 update of this
         rank's blocks (`shard_local` of the mean; donated:
         `Optimizer.update_`); the metrics averaged over pod and data.

    At D = M = 1 (1x1x1 on one card included) stage A's collectives are
    bypassed: the step is plain data parallelism over the pods. A batch
    P·D does not divide raises, or with `replicate_indivisible` (the
    dry-run's) runs whole on every rank.
    `state_shapes` is the global state tree (tensors or "meta" ones)
    including "err"; where nothing is split, a state built on the whole
    params serves as its own shapes.

    Returns (step, state_shardings): `step(state, batch) -> (state,
    metrics)` is what `fault.run_training` drives, on a state of this
    rank's blocks (`dist.sharding.place` under the params' and moments'
    specs) with "err" from `init_dp_err` on the whole params;
    `state_shardings` (`NamedSharding`s mirroring `state_shapes`) covers
    params and moments under `state_specs` and the error buffers under
    ("pod",), which `checkpoint.save` / `restore` read. Spans: `train/grads`, `train/reduce`, `train/update` (each
    waits for the card when telemetry is on).
    """
    sizes = shd.axis_sizes(mesh)
    if "pod" not in sizes:
        raise ValueError(
            f"make_multipod_train_step needs a 'pod' mesh axis, got "
            f"{tuple(sizes)} (launch.mesh.make_multipod_mesh)"
        )
    if compress and scheme not in _SCHEMES:
        raise ValueError(f"scheme {scheme!r}: expected one of {_SCHEMES}")
    core = {k: state_shapes[k] for k in ("params", "opt", "step")}
    specs = {**state_specs(core, cfg, mesh),
             "err": tree_map(lambda _: ("pod",), state_shapes["err"])}
    shardings = shd.named(specs, mesh)
    p_specs = specs["params"]
    group = mesh.get_group("pod")
    pod = mesh.get_local_rank("pod")
    if dist.get_rank(group) != pod:
        # the two-stage all-to-all sends row j to the j-th rank of the
        # group: that rank must be pod j
        raise RuntimeError(
            f"rank {dist.get_rank()}: position {dist.get_rank(group)} in "
            f"the 'pod' group differs from its coordinate {pod}"
        )
    grad_fn = _grad_fn(loss_fn)

    def step(state: dict, batch: Any) -> tuple[dict, dict]:
        tel = obs.get()
        local = _rows(batch, cfg, mesh,
                      replicate_indivisible=replicate_indivisible)
        with tel.span("train/grads", cat="train"):
            grads, metrics = _block_grads(grad_fn, state["params"], local,
                                          cfg, mesh, p_specs, n_micro)
            grads = shd.unplace(grads, p_specs, mesh)
            tel.block(leaves(grads)[:1])  # one stream: one wait
        with tel.span("train/reduce", cat="train"):
            _reduce_grads(grads, state["err"], group, compress=compress,
                          scheme=scheme)
            tel.block(leaves(grads)[:1])
        with tel.span("train/update", cat="train"):
            gnorm = (clip_by_global_norm_(grads, clip_norm) if clip_norm
                     else global_norm(grads))
            optimizer.update_(_blocks(grads, p_specs, mesh), state["opt"],
                              state["params"], state["step"])
            state["step"].add_(1)
            tel.block(gnorm)
        return state, {**_pmean(metrics, group), "grad_norm": gnorm}

    step = obs.get().probe.track(
        "train.multipod.step", step, budget=_TRAIN_COMM_ENVELOPE,
        donate=(0,), sharded_outputs=True, mesh=mesh, out_specs=[specs])
    return step, shardings

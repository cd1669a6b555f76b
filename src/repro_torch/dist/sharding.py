"""Mesh-aware partition rules: params, batches, caches (port of
`repro.dist.sharding`).

One rule table serves every architecture because the param trees follow
two conventions (see `models/layers.py`): 2-D weights are
(in_features, out_features), and path names identify the role of each
linear. The physical axes come from `launch/mesh.py`:

  data  — DP + FSDP (ZeRO-style parameter/optimizer sharding);
  model — TP (attention heads / ffn columns / vocab / MoE hidden);
  pod   — pure DP across pods (params replicated; `dist.compression`
          owns the cross-pod gradient traffic).

The config's parallelism profile gates the rules: `use_tp=False` folds
the model axis into data parallelism (params fully replicated,
`data_axes` returns every mesh axis); `fsdp=False` drops the data-axis
entries. Every axis assignment passes the `_dim_ok` divisibility guard —
a dimension the axis does not divide is left unsharded rather than
padded here (padding is the model's job, see `transformer.Dims`).

The rules are pure functions of leaf shapes and a mesh's axis names and
sizes. A spec is a tuple with one entry per dimension — `None`, an axis
name, or a tuple of names — which is what a jax `PartitionSpec` holds;
replicated leaves get the empty tuple, as the reference's `P()`. The
`mesh` argument is anything with those names and sizes: a torch
`DeviceMesh` (`mesh_dim_names`, `shape`), or a `MeshShape` stand-in
that has no process group behind it.

`named` pairs each spec with its mesh (`NamedSharding`), and
`shard_local` cuts the block of a global tensor that this rank holds
under a spec, the counterpart of placing an array under a jax
`NamedSharding`; `place` does it for a whole tree, copying each split
leaf's block once into its own storage.

Where the reference lets GSPMD insert the collectives a placement needs,
the port runs one process a device and makes them explicit.
`activation_context(cfg, mesh, specs=)` is where a layer learns them: the
data and model groups of the mesh (`mesh_groups`), this
rank's coordinate in each, and the parameters' spec tree. Inside it:

  * `gather_block` hands a block its parameters as the layers take them:
    every leaf split over `data` (FSDP) all-gathered over the data group
    in one collective, every linear whose weight is split over `model`
    marked `"tp": "col"` (its output columns) or `"tp": "row"` (its input
    rows), which `models.layers` reads, and an MoE dict whose bare expert
    arrays split their hidden axis over `model` marked `"tp": "hidden"`,
    which `models.moe` reads;
  * `all_reduce` / `all_gather` / `reduce_scatter` run a collective over
    a group and count it by kind in `comm_calls` (the budgets of a
    decode step and of a train step read them), and its operand's bytes
    in `comm_bytes` (the dry-run's collective term reads them);
  * `constrain(x, *logical, shape=)` keeps the reference's layout hints:
    on a rank-local tensor it checks that each dim is the block the
    logical axis implies of the global `shape` (a logical axis whose
    size does not divide the dim is dropped, as in the reference), and
    raises otherwise. It never moves data.

The mesh is ("data", "model") or, for multi-pod training, ("pod",
"data", "model"): the batch is split over ("pod", "data"), the groups
are this rank's pod's, and no layer enters the pod axis (the trainer
reduces over it, `dist.compression`).

Training differentiates through the collectives. Each one the layers
reach is a `torch.autograd.Function` whose backward is the adjoint that
keeps every gradient whole where its tensor is replicated (the
collectives of the backward are counted too, by kind):

  forward                                   backward
  `reduce_model`  partial sums -> replicated   identity
  `gather_model`  local blocks -> replicated   this rank's block (slice)
  `model_block`   replicated -> local block    all-gather over `model`
  `enter_model`   identity (replicated x       all-reduce over `model`
                  entering local compute)      (Megatron's "f")
  `gather_block`  FSDP all-gather over `data`  reduce-scatter (sum)

The rule behind the table: a tensor replicated over `model` that feeds a
rank-local computation (a column-parallel linear, local heads or
channels, a replicated scale applied to local heads) gets only that
computation's partial gradient on each rank, so it goes through
`enter_model` on that branch alone; `model_block`'s all-gather makes its
own branch whole, so the two are never stacked. Without it `dx` and
every replicated leaf's gradient would differ between `model` ranks.
`torch.distributed.nn.functional.all_reduce` is not used: its backward
all-reduces again, which multiplies replicated gradients by the model
size. The FSDP reduce-scatter sums over `data`; the trainer divides by
the data size (`train.trainer`). Without gradients (serving) each is
its bare collective.

Outside a context `constrain` is the identity and nothing is gathered,
so model code runs unsharded by default.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch._tree import leaves, map_with_path, tree_map

Spec = tuple


class ShardingGuardError(ValueError):
    """A leaf that must be sharded (strict mode) failed the divisibility
    guard and would have been silently replicated on every device."""


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes without devices: what the rules
    read. `MeshShape(("data", "model"), (2, 4))`."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's `jax.sharding.NamedSharding`)."""

    mesh: Any
    spec: Spec


# ---------------------------------------------------------------------------
# Axis helpers
# ---------------------------------------------------------------------------


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh` or of anything with
    `axis_names` and a `shape` mapping names to sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axis_names(mesh) -> tuple:
    return tuple(axis_sizes(mesh))


def _axis_size(axis, mesh) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(_axis_size(a, mesh) for a in axis)
    return axis_sizes(mesh)[axis]


def _dim_ok(dim: int, axis, mesh) -> bool:
    """Can `dim` be sharded over `axis` (a name, tuple of names, or
    None) without padding?"""
    size = _axis_size(axis, mesh)
    return size <= 1 or dim % size == 0


def data_axes(cfg, mesh) -> tuple[str, ...]:
    """Mesh axes carrying the batch dimension. TP profiles reserve the
    'model' axis; pure-DP profiles (use_tp=False) fold it into DP."""
    if cfg.use_tp:
        return tuple(n for n in axis_names(mesh) if n != "model")
    return axis_names(mesh)


def _fsdp_axis(cfg, mesh) -> Optional[str]:
    if cfg.fsdp and "data" in axis_names(mesh):
        return "data"
    return None


def _tp_axis(cfg, mesh) -> Optional[str]:
    if cfg.use_tp and "model" in axis_names(mesh):
        return "model"
    return None


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

# in_features -> fsdp, out_features -> tp (column-parallel). The
# recurrent-family projections (rg-lru w_x/w_i/w_a, rwkv6
# w_r/w_k/w_v/w_g/cm_k/cm_r) are column-parallel too: the rg-lru
# recurrence is elementwise in the hidden dim and rwkv mixes per-head,
# so splitting their output columns over tp is exact.
_COL_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up",
                 "w_x", "w_i", "w_a", "w_r", "w_k", "w_v", "w_g",
                 "cm_k", "cm_r")
# in_features -> tp, out_features -> fsdp (row-parallel)
_ROW_PARALLEL = ("wo", "w_down", "w_out", "w_o", "cm_v")
# always replicated (norm scales/biases, linear biases, quant scales)
_REPLICATED_LEAVES = ("scale", "bias", "b", "meta")

_MOE_WEIGHTS = ("w_gate", "w_up", "w_down")


def _guarded(shape: Sequence[int], last_two: tuple, mesh) -> Spec:
    """Spec for `shape`: `last_two` axes on the trailing two dims (guard
    applied per-dim), None on every leading (stack) dim."""
    nd = len(shape)
    entries: list[Any] = [None] * nd
    for off, axis in enumerate(last_two):
        i = nd - 2 + off
        if i < 0:
            continue
        if axis is not None and _dim_ok(shape[i], axis, mesh):
            entries[i] = axis
    return tuple(entries)


def spec_for_path(path: str, shape: Sequence[int], cfg, mesh) -> Spec:
    """Spec for one parameter leaf, identified by its '/'-joined tree
    path (e.g. "blocks/pos0/mix/wq/w")."""
    parts = [p for p in path.split("/") if p]
    leaf = parts[-1]
    fsdp = _fsdp_axis(cfg, mesh)
    tp = _tp_axis(cfg, mesh)

    if leaf in _REPLICATED_LEAVES or (parts and parts[-2:-1] == ["meta"]):
        return ()

    # raw-tensor leaves (MoE expert stacks) are named directly; linear
    # leaves are {"w"} dicts named by their parent module
    name = parts[-2] if leaf in ("w", "packed", "values_q", "select") \
        else leaf
    in_moe = "moe" in parts

    if in_moe and name in _MOE_WEIGHTS:
        if getattr(cfg, "moe_shard", "tp_fsdp") == "tp_only":
            fsdp = None  # experts replicated over data
        if name == "w_down":
            return _guarded(shape, (tp, fsdp), mesh)
        return _guarded(shape, (fsdp, tp), mesh)

    if name == "embed":
        # vocab rows on tp, d_model on fsdp
        return _guarded(shape, (tp, fsdp), mesh)
    if name == "lm_head":
        return _guarded(shape, (fsdp, tp), mesh)
    if name == "router":
        return _guarded(shape, (fsdp, None), mesh)
    if name in _COL_PARALLEL:
        return _guarded(shape, (fsdp, tp), mesh)
    if name in _ROW_PARALLEL:
        return _guarded(shape, (tp, fsdp), mesh)
    # unknown leaves (recurrent-block internals, pos_emb, compiled
    # serving formats): replicate, dim-for-dim
    return (None,) * len(shape)


def _path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def param_specs(shapes: Any, cfg, mesh) -> Any:
    """Spec tree mirroring a parameter (shape) tree."""
    return map_with_path(
        lambda path, leaf: spec_for_path(_path_str(path), _shape(leaf),
                                         cfg, mesh),
        shapes,
    )


# ---------------------------------------------------------------------------
# Batch / cache rules
# ---------------------------------------------------------------------------


def batch_specs(tree: Any, cfg, mesh, *, strict: bool = False) -> Any:
    """Shard the leading (batch) dim of every leaf over the data axes;
    everything else replicated. Leaves whose batch dim the combined
    data-axis size does not divide stay unsharded — or, under
    `strict=True`, raise `ShardingGuardError` instead of silently
    replicating."""
    axes = data_axes(cfg, mesh)
    n_data = _axis_size(axes, mesh)

    def one(leaf):
        shape = _shape(leaf)
        if not shape:
            if strict and n_data > 1:
                raise ShardingGuardError(
                    f"batch_specs(strict): scalar leaf has no batch dim "
                    f"to shard over data axes {axes} (size {n_data})"
                )
            return ()
        first = axes if _dim_ok(shape[0], axes, mesh) else None
        if strict and n_data > 1 and first is None:
            raise ShardingGuardError(
                f"batch_specs(strict): batch dim {shape[0]} of leaf "
                f"shape {shape} not divisible by data axes "
                f"{axes} (size {n_data})"
            )
        return (first,) + (None,) * (len(shape) - 1)

    return tree_map(one, tree)


_KV_LEAVES = ("k", "v", "k_scale", "v_scale", "cross_k", "cross_v")


def cache_batch_axis(path_parts: Sequence[str]) -> int:
    """Index of the pool-slot (batch) axis for one decode-cache leaf,
    identified by its tree path: stacked subtrees ("blocks", "dec")
    carry a leading layer-group axis before the batch axis."""
    return 1 if path_parts and path_parts[0] in ("blocks", "dec") else 0


def cache_specs(cache: Any, cfg, mesh, *, strict: bool = False) -> Any:
    """Decode-cache rules: batch dim over the data axes; KV-head dim of
    attention buffers over the model axis. Stacked subtrees ("blocks",
    "dec") carry a leading layer-group dim before the batch dim.

    `strict=True` raises `ShardingGuardError` for any leaf whose batch
    dim the combined data-axis size does not divide. The KV-head /
    model-axis rule stays best-effort even under strict."""
    axes = data_axes(cfg, mesh)
    n_data = _axis_size(axes, mesh)
    tp = _tp_axis(cfg, mesh)

    def one(path, leaf):
        parts = [str(p) for p in path]
        shape = _shape(leaf)
        b_idx = cache_batch_axis(parts)
        entries: list[Any] = [None] * len(shape)
        if len(shape) > b_idx:
            if _dim_ok(shape[b_idx], axes, mesh):
                entries[b_idx] = axes
            elif strict and n_data > 1:
                raise ShardingGuardError(
                    f"cache_specs(strict): leaf {'/'.join(parts)} shape "
                    f"{shape} batch dim {shape[b_idx]} (index "
                    f"{b_idx}) not divisible by data axes {axes} "
                    f"(size {n_data})"
                )
        # leaves with no batch dim replicate even under strict: they do
        # not scale with the pool
        h_idx = b_idx + 2  # (B, slots, heads, ...) layout
        if (
            parts[-1] in _KV_LEAVES
            and tp is not None
            and len(shape) > h_idx
            and _dim_ok(shape[h_idx], tp, mesh)
        ):
            entries[h_idx] = tp
        return tuple(entries)

    return map_with_path(one, cache)


def spec_shard_factor(spec: Spec, mesh) -> int:
    """How many ways `spec` splits one tensor over `mesh` (product of
    the mesh-axis sizes it names); per-device bytes = nbytes / factor."""
    return math.prod(_axis_size(entry, mesh) for entry in spec)


def _itemsize(dtype) -> int:
    return int(getattr(dtype, "itemsize"))


def bytes_per_device(tree: Any, specs: Any, mesh) -> int:
    """Per-device bytes of `tree` placed with `specs`, from shapes alone:
    each leaf contributes nbytes / spec_shard_factor. `specs` mirrors
    `tree` leaf for leaf (the trees `param_specs`, `cache_specs` and
    `batch_specs` return); leaves without a shape or dtype count 0."""
    tree_leaves = leaves(tree)
    spec_leaves = []
    tree_map(spec_leaves.append, specs)
    if len(tree_leaves) != len(spec_leaves):
        raise ValueError(
            f"tree has {len(tree_leaves)} leaves but specs {len(spec_leaves)}"
        )
    total = 0
    for leaf, spec in zip(tree_leaves, spec_leaves):
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is None or dtype is None:
            continue
        nbytes = math.prod(shape) * _itemsize(dtype)
        total += nbytes // spec_shard_factor(spec, mesh)
    return total


def named(specs: Any, mesh) -> Any:
    """Spec tree -> `NamedSharding` tree (None passes through)."""
    return tree_map(
        lambda s: None if s is None else NamedSharding(mesh, s), specs
    )


# ---------------------------------------------------------------------------
# This rank's block
# ---------------------------------------------------------------------------


def _coordinate(axis, mesh) -> int:
    """This rank's index along `axis` (a name or tuple of names, the
    first name outermost)."""
    if isinstance(axis, (tuple, list)):
        idx = 0
        for a in axis:
            idx = idx * _axis_size(a, mesh) + _coordinate(a, mesh)
        return idx
    return mesh.get_local_rank(axis)


def shard_local(x, spec: Spec, mesh):
    """The block of the global tensor `x` that this rank of the
    `DeviceMesh` `mesh` holds under `spec`: each sharded dim is cut into
    as many equal parts as its axes' sizes multiply to, and this rank
    keeps the part at its coordinate. A view where `x` is a tensor.
    Raises where an axis does not divide its dim."""
    out = x
    for dim, axis in enumerate(spec):
        size = _axis_size(axis, mesh)
        if size <= 1:
            continue
        if x.shape[dim] % size:
            raise ShardingGuardError(
                f"shard_local: dim {dim} of shape {tuple(x.shape)} not "
                f"divisible by {axis} (size {size})"
            )
        part = x.shape[dim] // size
        lo = _coordinate(axis, mesh) * part
        out = out.narrow(dim, lo, part) if hasattr(out, "narrow") else (
            out[(slice(None),) * dim + (slice(lo, lo + part),)])
    return out


def global_shape(local_shape: Sequence[int], spec: Spec, mesh) -> tuple:
    """The global shape whose `shard_local` block under `spec` has
    `local_shape`."""
    shape = list(local_shape)
    for dim, axis in enumerate(spec):
        shape[dim] *= _axis_size(axis, mesh)
    return tuple(shape)


def _names(entry) -> tuple:
    """The mesh-axis names one spec entry carries."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def place(tree: Any, specs: Any, mesh) -> Any:
    """This rank's block of every leaf of `tree` under `specs` (mirroring
    `tree` leaf for leaf) on the `DeviceMesh` `mesh`. A leaf its spec does
    not split is kept as it is; a split leaf's block is copied once into
    its own contiguous storage, so the full tree can be freed after.
    Non-tensor leaves pass through."""

    def one(leaf, spec):
        if (not isinstance(leaf, torch.Tensor)
                or spec_shard_factor(spec, mesh) == 1):
            return leaf
        return shard_local(leaf, spec, mesh).clone(
            memory_format=torch.contiguous_format)

    return tree_map(one, tree, specs)


def unplace(tree: Any, specs: Any, mesh) -> Any:
    """The global tensors of a tree of this rank's blocks under `specs`
    on the `DeviceMesh` `mesh` (`place`'s inverse), replicated on every
    rank: for each mesh axis, innermost first, the leaves it splits
    all-gathered over its group in one collective. Leaves no spec splits
    are kept as they are."""
    sizes = axis_sizes(mesh)
    out = dict(enumerate(leaves(tree)))
    spec_list = []
    tree_map(spec_list.append, specs)
    for axis in reversed(tuple(sizes)):
        if sizes[axis] == 1:
            continue
        found = [(i, d) for i, spec in enumerate(spec_list)
                 for d, e in enumerate(spec) if axis in _names(e)]
        if found:
            got = all_gather_many([out[i] for i, _ in found],
                                  [d for _, d in found],
                                  mesh.get_group(axis))
            for (i, _), x in zip(found, got):
                out[i] = x
    it = iter(out[i] for i in range(len(out)))
    return tree_map(lambda _: next(it), tree)


def placed_bytes(tree: Any) -> int:
    """Bytes of the tensors of a (placed) tree on this rank."""
    return sum(x.numel() * x.element_size() for x in leaves(tree)
               if isinstance(x, torch.Tensor))


# ---------------------------------------------------------------------------
# Collectives, counted
# ---------------------------------------------------------------------------

comm_calls: dict[str, int] = {}  # collectives handed over, by kind
# the bytes handed to them, by kind: each call's operand (a rank's block
# for an all-gather, the whole tensor for a reduce-scatter), the
# reference's `launch.hlo_analysis` convention
comm_bytes: dict[str, int] = {}


def reset_comm() -> None:
    comm_calls.clear()
    comm_bytes.clear()


def _count(kind: str, x: torch.Tensor) -> None:
    comm_calls[kind] = comm_calls.get(kind, 0) + 1
    comm_bytes[kind] = comm_bytes.get(kind, 0) + x.numel() * x.element_size()


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or another `op`) of `x` over `group` (a new contiguous
    tensor where `x` is not contiguous; else `x` itself, reduced in
    place)."""
    x = x.contiguous()
    _count("all-reduce", x)
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's `x` of `group`, concatenated along `dim` in the
    group's rank order (a mesh axis's coordinate order)."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
    _count("all-gather", x)
    dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
    return torch.cat(out.view(n, *x.shape).unbind(0), dim=dim)


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's part of the sum of `x` over `group`: `x` is (n *
    numel,) laid out rank block by rank block; the result (numel,)."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((x.numel() // n,), dtype=x.dtype, device=x.device)
    _count("reduce-scatter", x)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


class _ReduceSum(torch.autograd.Function):
    """Sum of partial products over a group -> replicated; backward: the
    identity (each rank's partial contributes the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Local blocks joined along `dim` -> replicated; backward: this
    rank's block of the (replicated, whole) gradient."""

    @staticmethod
    def forward(ctx, x, group, dim, rank):
        ctx.dim, ctx.rank, ctx.part = dim, rank, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.part, ctx.part), None, \
            None, None


class _Block(torch.autograd.Function):
    """This rank's block of a replicated tensor along `dim`; backward:
    every rank's block gradient all-gathered (the other blocks' gradients
    are the other ranks')."""

    @staticmethod
    def forward(ctx, x, group, dim, rank, n):
        ctx.group, ctx.dim = group, dim
        part = x.shape[dim] // n
        return x.narrow(dim, rank * part, part)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None, None, None


class _Enter(torch.autograd.Function):
    """Identity on a replicated tensor that enters rank-local compute;
    backward: the partial gradients all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _GatherMany(torch.autograd.Function):
    """`all_gather_many` (the FSDP gather of a block's leaves); backward:
    each leaf's gradient summed over the group into this rank's block, in
    one reduce-scatter a dtype."""

    @staticmethod
    def forward(ctx, group, dims, *xs):
        ctx.group, ctx.dims = group, dims
        ctx.shapes = [x.shape for x in xs]
        return tuple(all_gather_many(list(xs), list(dims), group))

    @staticmethod
    def backward(ctx, *gs):
        n = dist.get_world_size(ctx.group)
        out: list = [None] * len(gs)
        for dt in dict.fromkeys(g.dtype for g in gs):
            idx = [i for i, g in enumerate(gs) if g.dtype == dt]
            # (n, numel) a leaf: row r is rank r's block of its gradient
            rows = [torch.stack(gs[i].chunk(n, dim=ctx.dims[i])).reshape(
                n, -1) for i in idx]
            mine = reduce_scatter(torch.cat(rows, dim=1).reshape(-1),
                                  ctx.group)
            off = 0
            for i in idx:
                size = math.prod(ctx.shapes[i])
                out[i] = mine[off:off + size].view(ctx.shapes[i])
                off += size
        return (None, None, *out)


def all_gather_many(xs: list, dims: list, group) -> list:
    """`all_gather(x, group, dim)` of every x in `xs` in one collective:
    their bytes packed into one buffer (each at a 16-byte offset), the
    buffer gathered, each tensor's rank blocks joined along its dim."""
    n = dist.get_world_size(group)
    parts, spans, off = [], [], 0
    for x in xs:
        b = x.contiguous().reshape(-1).view(torch.uint8)
        pad = (-b.numel()) % 16
        parts.append(b)
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8, device=b.device))
        spans.append((off, b.numel()))
        off += b.numel() + pad
    buf = torch.cat(parts)
    out = torch.empty((n * off,), dtype=torch.uint8, device=buf.device)
    _count("all-gather", buf)
    dist.all_gather_into_tensor(out, buf, group=group)
    out = out.view(n, off)
    got = []
    for x, d, (o, nb) in zip(xs, dims, spans):
        blocks = out[:, o:o + nb].view(x.dtype).reshape(n, *x.shape)
        got.append(torch.cat(blocks.unbind(0), dim=d))
    return got


# ---------------------------------------------------------------------------
# Activation context: groups, coordinates, gathered blocks, constraints
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """A mesh's in-pod sub-groups through this rank: `data` (the ranks
    sharing its pod and model coordinates: FSDP gathers, the pool's rows,
    tokens) and `model` (the ranks sharing its pod and data coordinates:
    tensor-parallel partial sums and gathers), each None where its axis
    has size 1; the axes' sizes and this rank's coordinate on each."""

    data: Any
    model: Any
    n_data: int
    data_rank: int
    tp: int
    model_rank: int


def mesh_groups(mesh) -> MeshGroups:
    """The data and model sub-groups of a ("data", "model") or ("pod",
    "data", "model") `DeviceMesh` (an axis the mesh lacks counts as size
    1)."""
    names = tuple(mesh.mesh_dim_names or ())

    def axis(name: str) -> tuple:
        if name not in names:
            return None, 1, 0
        n = mesh.size(names.index(name))
        if n == 1:
            return None, 1, 0
        return mesh.get_group(name), n, mesh.get_local_rank(name)

    data, n_data, d = axis("data")
    model, tp, m = axis("model")
    return MeshGroups(data, model, n_data, d, tp, m)


@dataclasses.dataclass(frozen=True)
class Activations:
    """What a layer reads inside `activation_context`: the config, the
    mesh, the parameters' global spec tree (None: nothing is gathered),
    and the mesh's groups (`MeshGroups`)."""

    cfg: Any
    mesh: Any
    specs: Any
    groups: Any

    @property
    def tp(self) -> int:
        return self.groups.tp

    @property
    def n_data(self) -> int:
        return self.groups.n_data


_ACTIVATION_CTX: list[Activations] = []


@contextlib.contextmanager
def activation_context(cfg, mesh, *, specs: Any = None):
    """Makes `constrain`, `gather_block` and the tensor-parallel layers
    resolve against (cfg, mesh): the mesh's data and model groups and
    this rank's coordinate in each. `specs` is the parameters' spec tree
    (`param_specs`), which `gather_block` reads. Nestable; the innermost
    context wins. Every rank of the mesh enters it (building the groups
    is collective the first time). A pure-DP profile (`use_tp=False`)
    folds `model` into data parallelism: its rows are split there, no
    parameter is, so the layers see a model size of 1."""
    bad = [a for a in data_axes(cfg, mesh)
           if a not in ("pod", "data") + (() if cfg.use_tp else ("model",))
           and axis_sizes(mesh)[a] > 1]
    if bad:
        raise ShardingGuardError(
            f"activation_context: the batch would shard over {bad}; the "
            f"port runs over a ('data', 'model') or ('pod', 'data', "
            f"'model') mesh"
        )
    groups = mesh_groups(mesh)
    if not cfg.use_tp:
        groups = dataclasses.replace(groups, model=None, tp=1, model_rank=0)
    _ACTIVATION_CTX.append(Activations(cfg, mesh, specs, groups))
    try:
        yield
    finally:
        _ACTIVATION_CTX.pop()


def current() -> Optional[Activations]:
    """The innermost activation context, or None."""
    return _ACTIVATION_CTX[-1] if _ACTIVATION_CTX else None


def tp_size() -> int:
    """The model axis's size in the current context (1 outside one)."""
    ctx = current()
    return 1 if ctx is None else ctx.tp


def model_group():
    """The current context's model group: None outside one and at a model
    size of 1."""
    ctx = current()
    return None if ctx is None else ctx.groups.model


def model_block(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's block of the model-replicated `x` along `dim` (a view):
    the block a tensor split over `model` holds. Backward: all-gather."""
    ctx = current()
    if ctx is None or ctx.tp == 1:
        return x
    g = ctx.groups
    return _Block.apply(x, g.model, dim % x.ndim, g.model_rank, g.tp)


def gather_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model group's blocks of `x` joined along `dim`. Backward: this
    rank's block."""
    ctx = current()
    if ctx is None or ctx.tp == 1:
        return x
    g = ctx.groups
    return _Gather.apply(x, g.model, dim % x.ndim, g.model_rank)


def reduce_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model group's partial `x`. Backward: identity."""
    ctx = current()
    if ctx is None or ctx.tp == 1:
        return x
    return _ReduceSum.apply(x, ctx.groups.model)


def enter_model(x: torch.Tensor) -> torch.Tensor:
    """`x` (replicated over `model`) as it enters rank-local compute: the
    identity, whose backward all-reduces the partial gradients over
    `model`. Call it on that branch alone (see the module docstring)."""
    ctx = current()
    if ctx is None or ctx.tp == 1:
        return x
    return _Enter.apply(x, ctx.groups.model)


def _linear_weight(node: dict) -> Optional[str]:
    for k in ("w", "packed", "values_q"):
        if k in node and isinstance(node[k], torch.Tensor):
            return k
    return None


def check_row_groups(tree: Any, specs: Any, mesh, rows_of, what: str) -> None:
    """Raise `ShardingGuardError` where a row-parallel linear (its weight
    split over `model` on the rows, dim -2) would leave a rank a block
    that cuts one of its groups: `rows_of(node)` gives the rows of one
    group of the linear dict `node` (None: its rows are not grouped). A
    rank's block of a grouped weight is exact only in whole groups: the
    16:8 prune ranks within a group, and the compressed format's rows are
    whole groups of `keep`. The error names the leaf, its shape and the
    block."""
    n = _axis_size("model", mesh)
    if n <= 1:
        return

    def visit(node, spec, path):
        if not isinstance(node, dict):
            return
        w = _linear_weight(node)
        if w is not None:
            rows, s = rows_of(node), spec[w]
            shape = tuple(node[w].shape)
            if (rows and len(s) > 1 and "model" in _names(s[-2])
                    and (shape[-2] % n or (shape[-2] // n) % rows)):
                raise ShardingGuardError(
                    f"{what}: {'/'.join(path + (w,))} of shape {shape} "
                    f"split over model ({n}) on its rows leaves a block of "
                    f"{shape[-2] / n:g} rows, not a whole number of its "
                    f"{rows}-row groups")
            return
        for k, v in node.items():
            visit(v, spec[k], path + (k,))

    visit(tree, specs, ())


def gather_block(tree: Any, specs: Any) -> Any:
    """A block's rank-local parameters as its layers take them, inside an
    activation context: the leaves `specs` splits over `data` all-gathered
    over the data group (one collective for the block; the gathered
    tensors are the caller's to drop after the block; the backward
    reduce-scatters their gradients), and every linear
    whose weight `specs` splits over `model` marked `"tp": "col"` (the
    out-features, last dim) or `"tp": "row"` (the in-features); an MoE
    dict whose bare expert arrays split their hidden axis F over `model`
    is marked `"tp": "hidden"`. Outside a context, or on a 1x1 mesh,
    `tree` itself."""
    ctx = current()
    if ctx is None or (ctx.n_data == 1 and ctx.tp == 1):
        return tree
    mesh = ctx.mesh
    found: list = []  # (path, leaf, dim) of the data-split leaves

    def split(entry, axis) -> bool:
        return axis in _names(entry) and _axis_size(axis, mesh) > 1

    def visit(path, leaf, spec):
        if isinstance(leaf, torch.Tensor):
            dims = [i for i, e in enumerate(spec) if split(e, "data")]
            if dims:
                found.append((path, leaf, dims[0]))
        return leaf

    map_with_path(visit, tree, specs)
    gathered = {}
    if found:
        xs = _GatherMany.apply(ctx.groups.data,
                               tuple(d for _, _, d in found),
                               *(x for _, x, _ in found))
        gathered = {path: x for (path, _, _), x in zip(found, xs)}

    def rebuild(node, spec, path):
        if not isinstance(node, dict):
            return gathered.get(path, node)
        out = {k: rebuild(v, spec[k], path + (k,)) for k, v in node.items()}
        w = _linear_weight(node)
        if w is not None and ctx.tp > 1:
            s = spec[w]
            if s and split(s[-1], "model"):
                out["tp"] = "col"
            elif len(s) > 1 and split(s[-2], "model"):
                out["tp"] = "row"
        elif (ctx.tp > 1 and isinstance(node.get("w_gate"), torch.Tensor)
              and split(spec["w_gate"][-1], "model")):
            out["tp"] = "hidden"  # bare MoE experts: F over model
        return out

    return rebuild(tree, specs, ())


def constrain(x: torch.Tensor, *logical, shape: Optional[Sequence] = None
              ) -> torch.Tensor:
    """The reference's layout hint over logical axes ("dp", "tp", None),
    one per dim of `x`, on a rank-local tensor: each dim whose global
    size `shape` gives (None: not checked) must be this rank's block of
    it — the global size divided by the axis's size where that divides
    it, else whole (the reference drops such an axis). Raises
    `ShardingGuardError` otherwise; returns `x` unmoved. The identity
    outside `activation_context`."""
    ctx = current()
    if ctx is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError(
            f"constrain: {len(logical)} axes for rank-{x.ndim} tensor"
        )
    for i, ax in enumerate(logical):
        if ax not in ("dp", "tp", None):
            raise ValueError(f"unknown logical axis {ax!r}")
        full = None if shape is None else shape[i]
        if full is None:
            continue
        size = {"dp": ctx.n_data, "tp": ctx.tp, None: 1}[ax]
        want = full // size if size > 1 and full % size == 0 else full
        if x.shape[i] != want:
            raise ShardingGuardError(
                f"constrain: dim {i} of local shape {tuple(x.shape)} is "
                f"{x.shape[i]}, but {ax!r} over global {full} implies "
                f"{want}"
            )
    return x

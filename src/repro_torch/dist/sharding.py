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
`NamedSharding` for the replicated and batch-sharded leaves this port
places. The logical activation constraints (`constrain`,
`activation_context`) arrive with the placement of parameters over
`data` and `model` (ROADMAP.md queue 1 item 8b).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

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

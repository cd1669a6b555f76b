"""Per-slot decode-cache seating: scatter/gather pool rows of cache trees.

Port of `repro.serve.seating` (the dense pool; `scatter_pages` /
`gather_pages` come with the paged cache, ROADMAP.md queue 1 item 7).

Batched prefill admission produces a cache whose batch dimension holds
the *admitted* requests; the engine's pool cache holds `batch_size`
slots. `scatter_slots` writes admitted rows into their destination
slots, `gather_slots` reads slot rows back out. The slot axis of each
leaf comes from its tree path (`cache_batch_axis`, the rule of the
reference's `dist.sharding`): stacked subtrees ("blocks", "dec") carry
a leading layer-group axis before it.

`scatter_slots` writes into the pool's tensors in place and returns the
pool (the reference's engine donates the pool to a jitted scatter, which
XLA also updates in place); one `index_copy_` per leaf, O(seated rows).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch


def cache_batch_axis(path_parts: Sequence[str]) -> int:
    """Index of the pool-slot (batch) axis of one decode-cache leaf, from
    its tree path."""
    return 1 if path_parts and path_parts[0] in ("blocks", "dec") else 0


def _leaf_paths(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) of every leaf in insertion order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in _leaf_paths(v, path + (k,))]
    return [(path, tree)]


def slot_axes(tree: Any) -> list[int]:
    """Slot-axis index for every leaf of a cache tree, in leaf order."""
    return [cache_batch_axis(parts) for parts, _ in _leaf_paths(tree)]


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.long).to(device)


def scatter_slots(pool: Any, rows: Any, src, dst) -> Any:
    """Seat `rows` into `pool`: for every j, slot row `src[j]` of each
    `rows` leaf overwrites slot row `dst[j]` of the matching `pool` leaf
    (along that leaf's slot axis), in place. Every other slot — and
    every non-slot dimension — is untouched, so seating one request can
    never disturb a co-seated tenant. `dst` holds distinct slots.

    `rows` must mirror `pool`'s tree structure with the same per-leaf
    shapes except the slot axis; `src`/`dst` are (K,) index sequences.
    Returns `pool`.
    """
    flat = _leaf_paths(pool)
    row_leaves = [leaf for _, leaf in _leaf_paths(rows)]
    if len(flat) != len(row_leaves):
        raise ValueError(
            f"pool has {len(flat)} leaves but rows {len(row_leaves)} — "
            f"seating needs structurally matching cache trees"
        )
    for (parts, pl), rl in zip(flat, row_leaves):
        ax = cache_batch_axis(parts)
        sel = rl.index_select(ax, _index(src, rl.device))
        pl.index_copy_(ax, _index(dst, pl.device), sel.to(pl.dtype))
    return pool


def gather_slots(pool: Any, slots) -> Any:
    """Read slot rows back out: a tree mirroring `pool` whose slot axis
    holds `pool`'s rows `slots[0..K-1]`, in order (new tensors) — the
    inverse of `scatter_slots(pool, rows, arange(K), slots)`."""

    def one(tree, path):
        if isinstance(tree, dict):
            return {k: one(v, path + (k,)) for k, v in tree.items()}
        return tree.index_select(cache_batch_axis(path),
                                 _index(slots, tree.device))

    return one(pool, ())

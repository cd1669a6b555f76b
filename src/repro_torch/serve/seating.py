"""Per-slot decode-cache seating: scatter/gather pool rows of cache trees.

Port of `repro.serve.seating`: the dense pool (`scatter_slots`,
`gather_slots`) and the paged pool (`scatter_pages`, `gather_pages`).

Batched prefill admission produces a cache whose batch dimension holds
the *admitted* requests; the engine's pool cache holds `batch_size`
slots. `scatter_slots` writes admitted rows into their destination
slots, `gather_slots` reads slot rows back out. The slot axis of each
leaf comes from its tree path (`cache_batch_axis`, the rule of the
reference's `dist.sharding`): stacked subtrees ("blocks", "dec") carry
a leading layer-group axis before it.

On a mesh (`serve.sharded`) each rank holds its block of the pool's
slots (and, paged, its shard's pages): `rank_seats` keeps the seats whose
destination slot is this rank's, in its local numbering, and the same two
scatters then write them into the rank's block (the page table's rows
translated to the shard's local page numbers by the engine).

`scatter_slots` and `scatter_pages` write into the pool's tensors in
place and return the pool (the reference's engine donates the pool to a
jitted scatter, which XLA also updates in place); one `index_copy_` (or
one indexed write of all the seated rows' pages) per leaf, O(seated
rows).
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


def rank_seats(src, dst, lo: int, hi: int) -> tuple[list, list, list]:
    """The seats (src[j] -> dst[j]) whose destination slot lies in this
    rank's block [lo, hi) of the pool: their indices j, their source
    rows, and their slots numbered within the block."""
    keep = [j for j, d in enumerate(dst) if lo <= int(d) < hi]
    return (keep, [int(src[j]) for j in keep],
            [int(dst[j]) - lo for j in keep])


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


# leaf names that become (n_pages, page, ...) pools under paged layouts;
# slot_pos stays per-slot dense
PAGED_LEAVES = ("k", "v", "k_scale", "v_scale")


def _leaf_layout(parts: Sequence[str], layouts: dict) -> Any:
    """(pages_per_slot, page) for a paged pool leaf, else None."""
    if parts[-1] not in PAGED_LEAVES:
        return None
    return layouts.get("/".join(parts[:-1]))


def scatter_pages(pool: Any, rows: Any, src, dst, phys, *,
                  layouts: dict) -> Any:
    """Page-granular seating, the paged twin of `scatter_slots`, in place.

    `rows` is a *dense* admission cache (what batched prefill or the
    chunked-prefill cell produces: slot-axis leaves of capacity `cap`);
    `pool` is the engine's paged pool. Dense leaves (slot_pos, recurrent
    state) seat exactly as `scatter_slots`. Paged K/V leaves are split
    along the capacity axis into `pages_per_slot` logical pages, and
    logical page `lp` of seated row j is written to physical page
    `phys[j, lp]` (`phys` is the (K, span) table rows of the seated
    slots). Entries past a request's allocated pages point at the scratch
    page, so writing them is harmless by construction: scratch is never
    read unmasked. Those aliased writes land in an unspecified order on
    the card.

    `layouts` comes from `model.page_layouts(page)`. Returns `pool`.
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
        lay = _leaf_layout(parts, layouts)
        src_i = _index(src, rl.device)
        if lay is None:
            pl.index_copy_(ax, _index(dst, pl.device),
                           rl.index_select(ax, src_i).to(pl.dtype))
            continue
        maxp, page = lay
        # rows leaf: slot axis at `ax`, capacity right after it; pool
        # leaf: physical-page axis at `ax`, page offset right after it
        sel = rl.movedim((ax, ax + 1), (0, 1)).index_select(0, src_i)
        sel = sel[:, : maxp * page].reshape(-1, page, *sel.shape[2:])
        pm = pl.movedim((ax, ax + 1), (0, 1))  # a view: writes reach pl
        pm[_index(phys, pl.device)[:, :maxp].reshape(-1)] = sel.to(pl.dtype)
    return pool


def gather_pages(pool: Any, slots, phys, *, layouts: dict) -> Any:
    """Inverse of `scatter_pages`: dense cache rows for `slots[0..K-1]`
    from the paged pool (new tensors). Paged K/V leaves gather their
    mapped physical pages back into capacity order; dense leaves gather
    slot rows, exactly `gather_slots`."""

    def one(tree, path):
        if isinstance(tree, dict):
            return {k: one(v, path + (k,)) for k, v in tree.items()}
        ax = cache_batch_axis(path)
        lay = _leaf_layout(path, layouts)
        if lay is None:
            return tree.index_select(ax, _index(slots, tree.device))
        maxp, page = lay
        pm = tree.movedim((ax, ax + 1), (0, 1))  # (nP, page, ...)
        idx = _index(phys, tree.device)[:, :maxp]
        sel = pm[idx.reshape(-1)].reshape(idx.shape[0], maxp * page,
                                           *pm.shape[2:])
        return sel.movedim((0, 1), (ax, ax + 1))

    return one(pool, ())

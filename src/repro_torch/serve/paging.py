"""Fixed-size page pool for the serving cache: config + free-list allocator.

A copy of `repro.serve.paging` (pure Python, no jax) for the port.

The dense slot pool gives every tenant a full `max_len` cache row, so
resident bytes are `max_len x pool_size` regardless of actual prompt
lengths. Paged mode carves the attention K/V pool into fixed-size pages
behind a host-side slot->page indirection table: a slot only holds pages
for the positions it has actually written, so the same byte budget hosts
more concurrent tenants (the BENCH_decode `paged` section self-asserts
the >= 2x gain on a mixed-length workload).

This module is the pure-Python side: `PagingConfig` (validated against a
model's attention cache layout) and `PageAllocator`, a per-shard LIFO
free-list allocator. Everything device-side (pool leaves, gather-view
decode, page-granular seating) lives in `models/transformer.py` and
`serve/seating.py`; the engines own the numpy indirection table and call
into the allocator at admission, on page-boundary crossings during
decode, and at finish/shed.

Layout invariants the allocator maintains (fuzzed in
tests/test_paged_properties.py):

  * pages are partitioned into `n_shards` contiguous physical ranges so
    a slot's pages always live on the slot's data shard (the pool never
    unshards);
  * the LAST physical page of every shard is a reserved scratch page —
    never allocated.  Indirection entries of unmapped logical pages and
    of inactive slots point at scratch, so the pool-wide decode step
    (which re-feeds inactive slots their last token) can only ever
    scribble on scratch, never on a page that was freed and reallocated
    to a new tenant.  Scratch contents are garbage by design and are
    always masked out by `slot_pos` validity in attention;
  * reservation-then-alloc: `reserve()` at admission claims the
    worst-case page count for a request (prompt + max_new), `alloc()`
    at each page-boundary crossing draws down the reservation, so a
    seated request can never hit exhaustion mid-decode;
  * identical op sequences produce identical physical layouts (LIFO
    free lists, no randomness) — paged runs are bitwise reproducible.
"""

from __future__ import annotations

import dataclasses


class PagesExhaustedError(RuntimeError):
    """Typed page-pool exhaustion: raised instead of corrupting the table.

    Raised by `PageAllocator.reserve/alloc` when a shard's free list
    (net of outstanding reservations) cannot cover the request, and by
    `Engine.submit` for never-satisfiable requests (worst-case page need
    exceeding the whole usable pool). The frontend maps it to the typed
    `pages_exhausted` rejection reason.
    """


@dataclasses.dataclass(frozen=True)
class PagingConfig:
    """Page-pool geometry for a paged serving engine.

    page_size: positions per page. Must divide every attention block's
        cache capacity (window for local/chunked kinds, max_seq for
        global) so a cache row splits into whole pages and the ring
        arithmetic of windowed kinds is unchanged.
    n_pages: TOTAL physical pages in the pool (across all data shards;
        must divide by the mesh's data-shard count, which also reserves
        one scratch page per shard).
    """

    page_size: int
    n_pages: int

    def __post_init__(self) -> None:
        if self.page_size <= 0:
            raise ValueError(f"page_size must be positive, got {self.page_size}")
        if self.n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (one scratch + one usable), got {self.n_pages}"
            )


def pages_for_position(last_pos: int, page_size: int, span: int) -> int:
    """Logical pages a slot needs once position `last_pos` is written.

    A slot's logical pages are a contiguous prefix {0..j}: global blocks
    fill them in order, and windowed (ring) blocks re-use prefix pages
    because page_size divides the window. `span` is the per-slot
    indirection width (max cache capacity / page_size over attention
    blocks); ring wrap-around caps the need at span. span == 0 means a
    pure-recurrent model — paging degenerates to the dense pool.
    """
    if span == 0 or last_pos < 0:
        return 0
    return min(last_pos // page_size, span - 1) + 1


class PageAllocator:
    """Per-shard LIFO free-list page allocator with reservations.

    Physical pages [s*per_shard, (s+1)*per_shard) belong to shard s; the
    last page of each range is that shard's scratch page and is never
    handed out. All state is host-side Python — the device only ever
    sees the resulting indirection table.
    """

    def __init__(self, n_pages: int, n_shards: int = 1) -> None:
        if n_shards <= 0:
            raise ValueError(f"n_shards must be positive, got {n_shards}")
        if n_pages % n_shards != 0:
            raise ValueError(
                f"n_pages={n_pages} not divisible by n_shards={n_shards}"
            )
        per_shard = n_pages // n_shards
        if per_shard < 2:
            raise ValueError(
                f"need >= 2 pages per shard (scratch + usable), got {per_shard}"
            )
        self.n_pages = n_pages
        self.n_shards = n_shards
        self.per_shard = per_shard
        self.usable_per_shard = per_shard - 1
        # LIFO: pop() takes the lowest-numbered free page first.
        self._free: list[list[int]] = [
            list(range((s + 1) * per_shard - 2, s * per_shard - 1, -1))
            for s in range(n_shards)
        ]
        self._reserved: list[int] = [0] * n_shards
        # owner -> (shard, outstanding reservation, owned pages)
        self._owners: dict[object, tuple[int, int, list[int]]] = {}

    def scratch(self, shard: int = 0) -> int:
        """The never-allocated scratch page of `shard`."""
        return (shard + 1) * self.per_shard - 1

    def free_pages(self, shard: int = 0) -> int:
        return len(self._free[shard])

    def available(self, shard: int = 0) -> int:
        """Free pages net of outstanding reservations."""
        return len(self._free[shard]) - self._reserved[shard]

    def allocated_pages(self) -> int:
        return sum(len(o[2]) for o in self._owners.values())

    def owned(self, owner: object) -> tuple[int, ...]:
        ent = self._owners.get(owner)
        return tuple(ent[2]) if ent is not None else ()

    def reserve(self, owner: object, n: int, shard: int = 0) -> None:
        """Claim `n` pages of `shard` for `owner` without allocating them."""
        if owner in self._owners:
            raise ValueError(f"owner {owner!r} already holds a reservation")
        if n > self.available(shard):
            raise PagesExhaustedError(
                f"shard {shard}: need {n} pages, "
                f"{self.available(shard)} available "
                f"({len(self._free[shard])} free, "
                f"{self._reserved[shard]} reserved)"
            )
        self._reserved[shard] += n
        self._owners[owner] = (shard, n, [])

    def alloc(self, owner: object) -> int:
        """Draw one physical page from `owner`'s reservation."""
        ent = self._owners.get(owner)
        if ent is None:
            raise ValueError(f"owner {owner!r} has no reservation")
        shard, remaining, pages = ent
        if remaining <= 0:
            # Reservation exhausted: only proceed if the shard has slack
            # beyond everyone else's reservations (never steal).
            if self.available(shard) <= 0:
                raise PagesExhaustedError(
                    f"shard {shard}: owner {owner!r} exceeded its "
                    f"reservation and no unreserved pages remain"
                )
        else:
            self._reserved[shard] -= 1
        page = self._free[shard].pop()
        pages.append(page)
        self._owners[owner] = (shard, max(remaining - 1, 0), pages)
        return page

    def free(self, owner: object) -> int:
        """Release everything `owner` holds; returns the page count freed."""
        ent = self._owners.pop(owner, None)
        if ent is None:
            return 0
        shard, remaining, pages = ent
        self._reserved[shard] -= remaining
        # Push back in reverse so an identical re-run replays the exact
        # same physical layout (LIFO symmetry).
        for p in reversed(pages):
            self._free[shard].append(p)
        return len(pages)

    def check_invariants(self) -> None:
        """Fuzz-harness hook: blow up loudly on any broken invariant."""
        for s in range(self.n_shards):
            lo, hi = s * self.per_shard, (s + 1) * self.per_shard - 1
            owned = [
                p
                for (sh, _, pages) in self._owners.values()
                if sh == s
                for p in pages
            ]
            free = self._free[s]
            assert self._reserved[s] >= 0, "negative reservation count"
            assert self._reserved[s] <= len(free), "reserved beyond free"
            assert len(set(owned)) == len(owned), "double-allocated page"
            assert len(set(free)) == len(free), "duplicate free-list entry"
            assert not (set(owned) & set(free)), "page both owned and free"
            assert sorted(owned + free) == list(range(lo, hi)), (
                "page leak: owned+free != shard range"
            )


def validate_page_size(page_size: int, capacities: tuple[int, ...]) -> int:
    """Check page_size divides every attention cache capacity; return span.

    `capacities` are the attention blocks' cache capacities (empty for a
    pure-recurrent model). Returns the indirection-table width `span`
    (max capacity / page_size; 0 when there is nothing to page).
    """
    for cap in capacities:
        if cap % page_size != 0:
            raise ValueError(
                f"page_size={page_size} does not divide attention cache "
                f"capacity {cap}; pick a page size dividing every block's "
                f"window/max_seq"
            )
    return max((cap // page_size for cap in capacities), default=0)


__all__ = [
    "PageAllocator",
    "PagesExhaustedError",
    "PagingConfig",
    "pages_for_position",
    "validate_page_size",
]

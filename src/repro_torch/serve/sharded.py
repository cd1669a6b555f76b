"""Sharded LM decode: the serving engine on a ("data", "model") mesh (port
of `repro.serve.sharded`).

`serve.engine` runs prefill and slot decode on one device. This module
places the same computation on a `launch.mesh.make_serving_mesh` mesh:
parameters with `dist.sharding.param_specs` (FSDP rows over `data`, TP
columns over `model`), the decode caches with `cache_specs` (pool rows or
pages over `data`, KV heads over `model`) and the slot arrays' rows over
`data`, all under the strict divisibility guard, so a device holds its
share and never a silent replica.

The reference places global arrays and lets GSPMD insert the
collectives. The port runs one process a device (`launch._spawn`) and
makes both explicit:

  * placement is rank-local: `place_params` cuts this rank's block of
    every leaf once (`dist.sharding.place`), so the full tree can be
    freed; the cache is cut the same way;
  * the collectives are the layers' (`models.layers`, `models.transformer`,
    `models.rglru`, `models.moe`, `models.rwkv6`, inside
    `dist.sharding.activation_context`): each
    block's FSDP leaves all-gathered over `data` before it runs,
    row-parallel partial products all-reduced over `model`, mid-head
    projections and vocab-split logits gathered over `model`;
  * every rank runs the same host logic (admission, seating, EOS
    recycling, the page table), so every rank must see the same tokens
    every step: a rank decodes its block of the pool's rows, draws their
    tokens from whole logit rows (an argmax over a gathered row breaks
    ties to the lowest index, as over one device), and the tokens — not
    the logits — are all-gathered over `data`.

`dist.sharding.comm_calls` counts each collective by kind; a decode step
stays within `_decode_comm_budget`.

Layers:

  * `plan_decode`     — specs and per-device bytes for one (model, mesh,
                        pool size), no allocation; refuses what the port
                        cannot place (an indivisible pool, a local shape
                        `quant_matmul` cannot take);
  * `compile_decode`  — prefill and decode_step on rank-local tensors,
                        inside the activation context;
  * `sharded_generate`— batched generate (one prefill + N decode steps),
                        the mesh twin of `engine.generate`, greedy or
                        sampled under the same per-row keys;
  * `ShardedEngine`   — `engine.Engine` with its pool on the mesh, dense
                        or paged, chunked prefill included: this class
                        only overrides where arrays live and which rows a
                        rank computes.

On a data-only mesh each rank runs whole rows with the whole (gathered)
weights, so the outputs are the single-device engine's; with a model
axis, row-parallel contractions sum partial products, so logits agree to
fp tolerance only.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import _device
from repro_torch._tree import leaves, map_with_path
from repro_torch.dist import sharding as shd
from repro_torch.kernels import quant_matmul as QM
from repro_torch.models.api import Model
from repro_torch.serve import seating
from repro_torch.serve.engine import (
    Engine,
    _chunk_prefill_fn,
    _reject_enc_dec,
    fold_in,
    request_key,
    sample_tokens,
)
from repro_torch.serve.paging import PagingConfig, validate_page_size


def _decode_comm_budget(model: Model) -> dict:
    """The collectives a serve cell may hand to `torch.distributed`, by
    kind. Row- and column-parallel layers reduce or gather a handful of
    partials a layer, so the envelope scales with `n_layers`; what it
    catches is a per-step resharding that grows past O(layers)."""
    n = int(model.cfg.n_layers)
    per_layer_cap = 6 * n + 16
    return {
        "all-reduce": per_layer_cap,
        "all-gather": per_layer_cap,
        "reduce-scatter": per_layer_cap,
        "collective-permute": per_layer_cap,
        "all-to-all": per_layer_cap,
    }


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Placement plan for one (model, mesh, pool size): every spec the
    decode path needs, and per-device memory from the shapes (what a
    rank holds once placed, nothing allocated here). Specs are tuples
    with one entry a dim, as `dist.sharding` writes them. The pool's
    (B,) and (B, S) arrays shard their rows over `data` (the reference's
    `token`, `logits` and `prompts` shardings): `rows` is this rank's
    block of them."""

    mesh: Any
    batch: int
    n_devices: int
    n_data: int  # pool rows per device = batch / n_data
    tp: int
    rows: tuple  # this rank's block [lo, hi) of the pool's slots
    groups: Any  # dist.sharding.MeshGroups of this rank
    params: Any  # spec tree of the parameters
    cache: Any  # spec tree of the decode cache
    param_bytes_per_device: int
    cache_bytes_per_device: int
    param_bytes_total: int
    cache_bytes_total: int

    @property
    def cache_replication_factor(self) -> float:
        """1.0 = perfectly sharded; n_devices = fully replicated."""
        per_dev_if_perfect = self.cache_bytes_total / self.n_devices
        return self.cache_bytes_per_device / max(per_dev_if_perfect, 1)


def _replicated(specs: Any) -> Any:
    return map_with_path(lambda _, s: (None,) * len(s), specs)


def _check_kernel_shapes(params: Any, pspecs: Any, mesh, rows: int) -> None:
    """Raise `ShardingGuardError` where a packed leaf's local block under
    its spec is a shape the `quant_matmul` kernel cannot take at a decode
    step's `rows` rows (no fallback to the plain version), and where an
    SPE (values_q) linear's row block would cut a group of its compressed
    rows (`nm_spmm` runs a rank's block of whole groups)."""
    shd.check_row_groups(
        params, pspecs, mesh,
        lambda node: int(node["meta"]["keep"]) if "values_q" in node
        else None, "plan_decode")

    def one(path, leaf, spec):
        if path and path[-1] == "packed" and hasattr(leaf, "shape"):
            local = [d // shd._axis_size(a, mesh)
                     for d, a in zip(leaf.shape, spec)]
            kp, n = local[-2], local[-1]
            try:
                if kp < 1 or n < 1:
                    raise ValueError(f"an empty block ({kp}, {n})")
                QM.check_grid(rows, kp * 8, n)
            except ValueError as e:
                raise shd.ShardingGuardError(
                    f"plan_decode: {'/'.join(path)} of shape "
                    f"{tuple(leaf.shape)} under {spec} leaves a local "
                    f"block the quant_matmul kernel cannot take: {e}"
                ) from None
        return leaf

    map_with_path(one, params, pspecs)


def plan_decode(
    model: Model, params: Any, mesh, *, batch_size: int,
    strict: bool = True, paging: Optional[PagingConfig] = None,
) -> DecodePlan:
    """The placement plan. `params` may be the real tree or any tree of
    leaves with `shape` and `dtype`: only those are read. `strict=True`
    (the default) refuses a pool whose cache cannot shard its batch dim
    instead of replicating it on every device.

    With `paging`, the cache shapes come from `model.init_cache_paged`:
    attention K/V leaves become (n_pages, page, ...) pools whose page axis
    sits where the dense slot axis sat, so `cache_specs` shards pages over
    `data` with the same rule — provided `n_pages` divides by the data
    axis (guarded here; the engine's `PageAllocator` hands each slot pages
    from its own shard's contiguous range, the same split)."""
    cfg = model.cfg
    axes = shd.data_axes(cfg, mesh)
    n_data = shd._axis_size(axes, mesh)
    tp = shd.axis_sizes(mesh).get("model", 1) if cfg.use_tp else 1
    n_dev = math.prod(shd.axis_sizes(mesh).values())
    if batch_size % max(n_data, 1):
        raise shd.ShardingGuardError(
            f"decode pool batch_size={batch_size} not divisible by the "
            f"mesh data axes {axes} (size {n_data})"
        )
    meta = torch.device("meta")
    if (
        paging is not None
        and model.init_cache_paged is not None
        and validate_page_size(paging.page_size, model.attn_capacities())
    ):
        if paging.n_pages % max(n_data, 1):
            raise shd.ShardingGuardError(
                f"paged pool n_pages={paging.n_pages} not divisible by "
                f"the mesh data axes {axes} (size {n_data})"
            )
        cache_shapes = model.init_cache_paged(
            batch_size, paging.n_pages, paging.page_size, device=meta)
    else:
        cache_shapes = model.init_cache(batch_size, device=meta)
    pspecs = shd.param_specs(params, cfg, mesh)
    cspecs = shd.cache_specs(cache_shapes, cfg, mesh, strict=strict)
    _check_kernel_shapes(params, pspecs, mesh, batch_size // n_data)
    groups = shd.mesh_groups(mesh)
    per = batch_size // n_data
    return DecodePlan(
        mesh=mesh, batch=batch_size, n_devices=n_dev, n_data=n_data, tp=tp,
        rows=(groups.data_rank * per, (groups.data_rank + 1) * per),
        groups=groups, params=pspecs, cache=cspecs,
        param_bytes_per_device=shd.bytes_per_device(params, pspecs, mesh),
        cache_bytes_per_device=shd.bytes_per_device(cache_shapes, cspecs,
                                                    mesh),
        param_bytes_total=shd.bytes_per_device(params, _replicated(pspecs),
                                               mesh),
        cache_bytes_total=shd.bytes_per_device(
            cache_shapes, _replicated(cspecs), mesh),
    )


def _in_context(model: Model, plan: DecodePlan, fn: Callable) -> Callable:
    def run(*args):
        with shd.activation_context(model.cfg, plan.mesh, specs=plan.params):
            return fn(*args)

    return run


def compile_decode(model: Model, plan: DecodePlan) -> Tuple[Callable, Callable]:
    """(prefill, decode_step) on rank-local tensors: this rank's placed
    params, its block of the prompts' rows (or the pool's) and of the
    cache, run inside the plan's activation context. The cache keeps its
    placement across every step (updated in place, as on one device)."""
    _reject_enc_dec(model.cfg, "sharded decode (compile_decode)")
    return (_in_context(model, plan, model.prefill),
            _in_context(model, plan, model.decode_step))


def place_params(params: Any, plan: DecodePlan) -> Any:
    """This rank's block of every parameter (`dist.sharding.place`)."""
    return shd.place(params, plan.params, plan.mesh)


def _param_device(params: Any) -> torch.device:
    return next(x.device for x in leaves(params)
                if isinstance(x, torch.Tensor))


def sharded_generate(
    model: Model,
    params: Any,
    prompts: torch.Tensor,  # (B, S) int — same-length batch, every rank's
    *,
    mesh,
    max_new: int,
    params_placed: bool = False,
    plan: Optional[DecodePlan] = None,
    greedy: bool = True,
    key: Optional[tuple[int, ...]] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """The mesh's `engine.generate`: one sharded prefill + `max_new`
    sharded decode steps; every rank of the mesh calls it with the same
    prompts and gets the same (B, max_new) int64 tokens back (each rank
    decodes its block of the rows; the tokens are all-gathered over
    `data` once, at the end).

    Greedy by default; with `greedy=False` and a `key`, row b's token t is
    drawn with `fold_in(request_key(key, b), t)` — `engine.generate`'s
    schedule, so the two agree wherever their logits do. With `stats`
    (a dict), the bytes of the cache this rank holds (`cache_bytes`), each
    decode step's host time through a device synchronize
    (`decode_wall_ms`) and the collectives it handed over, by kind
    (`decode_comm`), are recorded there."""
    prompts = torch.as_tensor(prompts, dtype=torch.long)
    b, s = prompts.shape
    if plan is None:
        plan = plan_decode(model, params, mesh, batch_size=b)
    if plan.batch != b:
        raise ValueError(f"plan batch {plan.batch} != prompts batch {b}")
    prefill, decode = compile_decode(model, plan)
    if not params_placed:
        params = place_params(params, plan)
    dev = _param_device(params)
    lo, hi = plan.rows
    sampling = not greedy and key is not None

    def draw(logits, t):
        if not sampling:
            return torch.argmax(logits, dim=-1)
        return sample_tokens(
            logits, [fold_in(request_key(key, r), t) for r in range(lo, hi)],
            temperature=temperature, top_k=top_k,
        )

    if stats is not None:
        stats.setdefault("decode_wall_ms", [])
        stats.setdefault("decode_comm", [])
    last_logits, cache = prefill(params, prompts[lo:hi].to(dev))
    if stats is not None:
        stats["cache_bytes"] = shd.placed_bytes(cache)
    tok = draw(last_logits, 0)
    outs = []
    for t in range(max_new):
        outs.append(tok)
        pos = torch.full((hi - lo,), s + t, dtype=torch.long, device=dev)
        before = dict(shd.comm_calls)
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, tok, pos)
        tok = draw(logits, t + 1)
        if stats is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            stats["decode_wall_ms"].append((time.perf_counter() - t0) * 1e3)
            stats["decode_comm"].append({
                k: v - before.get(k, 0) for k, v in shd.comm_calls.items()
                if v != before.get(k, 0)})
    out = torch.stack(outs, dim=1)
    if plan.n_data > 1:
        out = shd.all_gather(out, plan.groups.data, 0)
    return out


class ShardedEngine(Engine):
    """The slot engine with its pool on a mesh, on every rank of it.

    Everything behavioral — batched prefill admission, scatter seating,
    EOS-on-first-token recycling, per-request sampling keys, the page
    table, chunked prefill — is `Engine`'s, run identically on every
    rank; this class only overrides where arrays live and which rows a
    rank computes: params and cache placed at construction; each decode
    step on the rank's block of the slots, its tokens all-gathered over
    `data`; admission widths padded to the data-axis multiple
    (`_admission_rows`; pad rows repeat the last prompt, their outputs
    discarded), each rank prefilling its block of the rows, the rows'
    caches all-gathered over `data` so every rank seats the slots it
    holds (`seating.rank_seats`); the page pool one shard a data rank,
    each rank's table rows in its shard's local page numbers. A chunked
    prefill's one-row cache is replicated over `data` (the reference's
    `_admission_rows(1)` rows, one a device, all the same row).

    `last_step_comm` holds the collectives of the last decode step, by
    kind (`dist.sharding.comm_calls`)."""

    def __init__(self, model: Model, params: Any, *, batch_size: int,
                 mesh, greedy: bool = True, strict: bool = True,
                 temperature: float = 1.0, top_k: int = 0,
                 key: Optional[tuple[int, ...]] = None,
                 paging: Optional[PagingConfig] = None,
                 chunk_tokens: Optional[int] = None,
                 device: _device.DeviceLike = None):
        # the plan must exist before Engine.__init__ runs the hooks
        self.mesh = mesh
        self._strict = strict
        self.plan = plan_decode(
            model, params, mesh, batch_size=batch_size, strict=strict,
            paging=paging,
        )
        self.last_step_comm: dict = {}
        super().__init__(
            model, params, batch_size=batch_size, greedy=greedy,
            temperature=temperature, top_k=top_k, key=key, paging=paging,
            chunk_tokens=chunk_tokens, device=device,
        )

    def _place_params(self, params: Any) -> Any:
        return place_params(params, self.plan)

    def _place_cache(self, cache: Any) -> Any:
        return shd.place(cache, self.plan.cache, self.mesh)

    def _place_batch(self, x):
        n = self.plan.n_data
        part = len(x) // n
        lo = self.plan.groups.data_rank * part
        return x[lo:lo + part]

    def _place_tbl(self, x: torch.Tensor) -> torch.Tensor:
        # this rank's rows address only its own shard's pages
        return x - self.plan.groups.data_rank * self._pg.per_shard

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        if self.plan.n_data == 1:
            return x
        return shd.all_gather(x, self.plan.groups.data, 0)

    def _gather_cache_rows(self, rows: Any) -> Any:
        if self.plan.n_data == 1:
            return rows
        flat = seating._leaf_paths(rows)
        got = shd.all_gather_many(
            [leaf for _, leaf in flat],
            [seating.cache_batch_axis(parts) for parts, _ in flat],
            self.plan.groups.data)
        out: dict = {}
        for (parts, _), x in zip(flat, got):
            node = out
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = x
        return out

    def _seat_rows(self, rows: Any, src, dst, width: int) -> None:
        # every rank runs the seat cell, as every device runs the
        # reference's; a rank none of whose slots are seated writes nothing
        seat = self._admission_cell(width)[1]
        lo, hi = self.plan.rows
        keep, src_l, dst_l = seating.rank_seats(src, dst, lo, hi)
        src_l, dst_l = self._index(src_l), self._index(dst_l)
        if self._pg is not None:
            phys = self._place_tbl(self._tbl_device([dst[j] for j in keep]))
            self.cache = seat(self.cache, rows, src_l, dst_l, phys)
        else:
            self.cache = seat(self.cache, rows, src_l, dst_l)

    def _cell(self, fn):
        return _in_context(self.model, self.plan, fn)

    # -- the cell auditor's declarations (the reference's shardings) --------

    def _logits_spec(self) -> tuple:
        """(rows, vocab) logits: rows over the data axes."""
        return (shd.data_axes(self.model.cfg, self.mesh), None)

    def _meta(self, out_specs) -> dict:
        return dict(budget=_decode_comm_budget(self.model),
                    sharded_outputs=True, mesh=self.mesh,
                    out_specs=out_specs)

    def _decode_meta(self) -> dict:
        return self._meta([self._logits_spec(), self.plan.cache])

    def _rows_out_specs(self, rows: int) -> list:
        """(logits, cache) specs of a `rows`-row admission cell: rows over
        the data axes, heads over `model`."""
        cache = self.model.init_cache(rows, device=torch.device("meta"))
        return [self._logits_spec(),
                shd.cache_specs(cache, self.model.cfg, self.mesh,
                                strict=self._strict)]

    def _admission_cell(self, rows: int):
        """`serve.prefill.w{rows}` and `serve.seat.w{rows}` (donating the
        pool), one pair a width, as the reference registers them."""
        cell = self._adm_cells.get(rows)
        if cell is None:
            cell = self._adm_cells[rows] = (
                self._probe.track(f"serve.prefill.w{rows}",
                                  self._cell(self.model.prefill),
                                  **self._meta(self._rows_out_specs(rows))),
                self._probe.track(f"serve.seat.w{rows}", self._seat_fn(),
                                  donate=(0,), sharded_outputs=True,
                                  mesh=self.mesh, out_specs=self.plan.cache),
            )
        return cell

    def _chunk_cell(self):
        """`serve.chunk.c{chunk_tokens}`. Each rank's one-row cache
        (`_chunk_cache`) is its block of the reference's chunk cache of
        `_admission_rows(1)` rows, one a data rank, every row the same."""
        c = self.chunk_tokens
        cell = self._chunk_cells.get(c)
        if cell is None:
            cell = self._chunk_cells[c] = self._probe.track(
                f"serve.chunk.c{c}", self._cell(_chunk_prefill_fn(self.model)),
                **self._meta(self._rows_out_specs(self._admission_rows(1))))
        return cell

    def _paging_shards(self) -> int:
        return max(self.plan.n_data, 1)

    def _admission_rows(self, n: int) -> int:
        # the admission prefill's rows divide over the data axis
        return n + (-n) % max(self.plan.n_data, 1)

    def _admit_span_attrs(self) -> dict:
        return {"mesh": "x".join(str(v) for v in
                                 shd.axis_sizes(self.mesh).values()),
                "n_data": int(self.plan.n_data)}

    def _chunk_cache(self) -> Any:
        cache = self.model.init_cache(1, device=self.device)
        return shd.place(
            cache, shd.cache_specs(cache, self.model.cfg, self.mesh),
            self.mesh)

    def _decode_tokens(self, toks, pos, keys) -> torch.Tensor:
        before = dict(shd.comm_calls)
        out = super()._decode_tokens(toks, pos, keys)
        self.last_step_comm = {
            k: v - before.get(k, 0) for k, v in shd.comm_calls.items()
            if v != before.get(k, 0)}
        return out

    @property
    def n_devices(self) -> int:
        return self.plan.n_devices

    @property
    def cache_bytes_per_device(self) -> int:
        return self.plan.cache_bytes_per_device

    @property
    def param_bytes_per_device(self) -> int:
        return self.plan.param_bytes_per_device

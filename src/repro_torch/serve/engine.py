"""Batched serving engine: batched prefill admission + slot decode.

Port of `repro.serve.engine` on the dense slot pool. A fixed pool of
`batch_size` decode slots runs one `decode_step` per tick for the whole
pool. Admission runs the real batched `model.prefill` over the requests
being seated (grouped by prompt length) and scatters the resulting
per-request cache rows into the pool (`serve.seating`) — O(prompt) work
per request, independent of the pool size. Finished slots (EOS or
max_new) are recycled.

Sampling: greedy argmax by default; with `greedy=False` every request
draws through `sample_tokens` (temperature / top-k) under a per-request
key — token t of request `uid` uses `fold_in(request_key(key, uid), t)`,
so streams are reproducible across runs and invariant to seat order and
co-tenancy. `generate` follows the same schedule (row index as uid).
The port cannot reproduce `jax.random` (threefry): a key here is a tuple
of ints, `fold_in` appends to it, and a draw takes one uniform from
numpy's generator seeded by `SeedSequence(key)` — one counter-keyed
stream per (seed, uid, t), as `data.iegm.segment_batch` keys its rows —
and inverts the row's categorical CDF with it.

Weight-only quantization (`quantize_for_serving`) converts dense params
to the packed mixed-bit-width format; the model's `linear_apply`
dispatches on the format, and packed projections run the hand-written
`quant_matmul` kernel on the card.

The decode cache is updated in place (`models.transformer`): the pool
re-feeds an inactive slot its last-fed (token, pos), which rewrites the
same K/V into the same ring slot, as in the reference.

Recurrent tenants (rg-lru, rwkv) are co-seated like attention ones:
seating overwrites a slot's whole cache row, and the idle-slot re-feed
advances a recurrent row that the next seating overwrites. An
encoder-decoder model (whisper) is refused by `Engine` and `generate` with
`EncDecUnsupportedError`, as in the reference: drive it through
`model.prefill(params, tokens, frames)` and `model.decode_step`.

Paging (`paging=PagingConfig(...)`): attention K/V live in a page pool
behind a host-side slot->page table (`serve.paging`); admission reserves
a request's worst-case pages, decode maps a new page at each page
boundary, and finishing returns them, so resident cache bytes follow the
positions actually written (`cache_bytes_in_use`). Chunked prefill
(`chunk_tokens=`): prompts longer than the chunk prefill in a standalone
rows-cache, one chunk a tick, so short requests admit and the pool
decodes in between; a chunked request takes a slot only when its prompt
is done.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import _device, obs
from repro_torch._tree import leaves
from repro_torch.concurrency import driver_thread_only
from repro_torch.models.api import Model
from repro_torch.models.layers import compile_linear_quant
from repro_torch.serve import seating
from repro_torch.serve.paging import (
    PageAllocator,
    PagesExhaustedError,
    PagingConfig,
    pages_for_position,
    validate_page_size,
)


# the names of the {"w"} linears packed at serve time. Everything else
# stays dense (numerically sensitive or tiny): embeddings and the lm_head,
# norms, the MoE router and its bare (E, d, f) expert arrays, rwkv's LoRA
# adapters and decay, RG-LRU's w_a / w_i gates
_QUANT_TARGETS = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "w_r", "w_k", "w_v", "w_g", "w_o", "cm_k", "cm_v", "cm_r",
    "w_x", "w_out",
)


class EncDecUnsupportedError(TypeError):
    """An encoder-decoder (whisper-family) model hit a decoder-only serving
    path. Drive it through `model.prefill(params, tokens, frames)` and
    `model.decode_step` instead."""


def _reject_enc_dec(cfg, where: str) -> None:
    if cfg.is_enc_dec:
        raise EncDecUnsupportedError(
            f"{where} drives the decoder-only path, but {cfg.name!r} is an "
            f"encoder-decoder model: its prefill needs audio frames. Run it "
            f"through model.prefill(params, tokens, frames) + "
            f"model.decode_step directly instead."
        )


def quantize_for_serving(params: Any, bits: int = 8) -> Any:
    """Dense master params -> packed mixed-bit-width serving params. The
    leaves it does not replace are shared with `params`."""

    def visit(tree, name=""):
        if isinstance(tree, dict):
            if "w" in tree and isinstance(tree["w"], torch.Tensor) and (
                name in _QUANT_TARGETS and tree["w"].ndim in (2, 3)
            ):
                return compile_linear_quant(tree, bits)
            return {k: visit(v, k) for k, v in tree.items()}
        return tree

    return visit(params)


# ---------------------------------------------------------------------------
# Sampling keys
# ---------------------------------------------------------------------------


def prng_key(seed: int) -> tuple[int, ...]:
    """The key of a run (`jax.random.PRNGKey`'s place)."""
    return (int(seed),)


def fold_in(key: tuple[int, ...], data: int) -> tuple[int, ...]:
    """A key derived from `key` and `data`, independent of its siblings."""
    return (*key, int(data))


def request_key(base: tuple[int, ...], uid: int) -> tuple[int, ...]:
    """Per-request key: the request uid folded into the engine/run key.
    Token t then folds t into this — the schedule both the engine and
    `generate` follow, so sampled streams match across paths and are
    invariant to seat order."""
    return fold_in(base, uid)


def _uniform(key: tuple[int, ...]) -> float:
    return float(np.random.default_rng(np.random.SeedSequence(key)).random())


def sample_tokens(
    logits: torch.Tensor,  # (B, V) float
    keys: Sequence[tuple[int, ...]],  # one key per row
    *,
    temperature: float = 1.0,
    top_k: int = 0,
) -> torch.Tensor:
    """Per-row temperature / top-k sampling. Returns (B,) int64.

    `top_k <= 0` or `top_k >= V` samples the full distribution. The
    top-k mask keeps every logit >= the k-th largest, so ties at the
    threshold are all eligible (deterministic given the key, never
    index-order-dependent). `temperature <= 0` degenerates to greedy
    argmax over the masked logits — identical to plain argmax, since
    masking only removes non-argmax entries. A draw inverts the row's
    CDF (float64) at the key's uniform.
    """
    logits = logits.to(torch.float32)
    v = logits.shape[-1]
    if top_k and top_k < v:
        thresh = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < thresh, -torch.inf, logits)
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    p = torch.softmax(logits.to(torch.float64) / float(temperature), dim=-1)
    cdf = torch.cumsum(p, dim=-1)
    u = torch.tensor([_uniform(k) for k in keys], dtype=torch.float64,
                     device=logits.device)
    idx = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)
    return idx[:, 0].clamp_max(v - 1)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: torch.Tensor  # (S,) int
    max_new: int = 32
    eos: Optional[int] = None
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _ChunkState:
    """One long prompt mid chunked-prefill: a standalone rows-cache the
    chunk cell advances `chunk_tokens` prompt tokens per tick, so the
    pool's decode ticks (and other admissions) interleave instead of
    stalling behind one O(prompt) prefill. Takes a pool slot only at
    completion."""

    req: Request
    cache: Any  # rows-format cache being built
    done: int  # prompt tokens already fed
    logits: Any = None  # (rows, V) last real step's logits once ready
    ready: bool = False


def _chunk_prefill_fn(model: Model):
    """Chunked-prefill cell body: `decode_step` over the `n` real tokens
    of one chunk; returns the last step's logits and the rows-cache.

    The reference scans a chunk padded to its full width and masks the
    pad steps' cache writes (`jnp.where(act, new, old)`). The port's
    decode step writes the cache in place, so a mask applied afterwards
    would restore nothing: the pad steps are not run at all, which leaves
    the same cache and the same last-real-step logits. (A recurrent block
    would advance its state on a pad step; running none keeps it
    exact.)"""

    def fn(params, cache, toks, poss, n: int):
        # toks / poss (rows, c) int64; the first n columns are real
        logits = None
        for t in range(n):
            logits, cache = model.decode_step(params, cache, toks[:, t],
                                              poss[:, t])
        return logits, cache

    return fn


class Engine:
    """Slot-based batched decoder around a Model, on one device (`None`
    means the CUDA card; `params` must be there).

    Admission is batched: each round takes up to |free slots| queued
    requests, groups them by prompt length, runs one `model.prefill` per
    group, and scatter-seats the resulting cache rows into the pool
    (`serve.seating.scatter_slots`, or `scatter_pages` when paged).
    `admission_rowsteps` counts the (row x token) units actually spent,
    `admission_prefills` the prefill cells run. With `paging`, K/V live
    in a page pool (see the module docstring); with `chunk_tokens`, longer
    prompts prefill in chunks between decode ticks.
    """

    def __init__(self, model: Model, params: Any, *, batch_size: int,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, key: Optional[tuple[int, ...]] = None,
                 paging: Optional[PagingConfig] = None,
                 chunk_tokens: Optional[int] = None,
                 device: _device.DeviceLike = None):
        _reject_enc_dec(model.cfg, "the slot engine")
        self.device = _device.resolve(device)
        self.model = model
        self.params = params
        self.batch = batch_size
        self.greedy = greedy
        self.temperature = temperature
        self.top_k = top_k
        self.key = key if key is not None else prng_key(0)
        if chunk_tokens is not None and chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
        self.chunk_tokens = chunk_tokens
        self.paging = paging
        self._pg: Optional[PageAllocator] = None
        self._page = 0
        self._span = 0
        self._layouts: dict = {}
        if paging is not None:
            if model.init_cache_paged is None:
                raise TypeError(
                    f"model {model.cfg.name!r} has no paged cache support"
                )
            self._page = paging.page_size
            self._span = validate_page_size(
                paging.page_size, model.attn_capacities()
            )
            if self._span:
                # pure-recurrent models have nothing to page: the paged
                # cache degenerates to the dense pool and no allocator is
                # needed (span == 0 keeps _pg None)
                self._layouts = model.page_layouts(paging.page_size)
                # one pool shard on one device (a sharded engine's pool
                # has one a data-axis device, ROADMAP.md queue 1 item 8b)
                self._pg = PageAllocator(paging.n_pages)
        if self._pg is not None:
            # host-authoritative slot->page table + per-slot mirrors (page
            # count, last written position). The device sees a copy of
            # _tbl each decode step, never stored in the cache tree
            self._tbl = np.full((batch_size, self._span),
                                self._pg.scratch(), np.int64)
            self._npages = [0] * batch_size
            self._hpos = [0] * batch_size
        probe = obs.get().probe
        self._decode = self._compile_decode()
        self._prefill = probe.track("serve.prefill", model.prefill)
        self._seat = probe.track(
            "serve.seat",
            functools.partial(seating.scatter_pages, layouts=self._layouts)
            if self._pg is not None else seating.scatter_slots,
        )
        self._chunk = probe.track("serve.chunk", _chunk_prefill_fn(model))
        self._queue: list[Request] = []
        self._slots: list[Optional[Request]] = [None] * batch_size
        self._chunks: list[_ChunkState] = []
        self._chunk_wait: list[Request] = []
        self.cache = self._init_cache()

        def zi():
            return torch.zeros((batch_size,), dtype=torch.long,
                               device=self.device)

        self.pos = zi()
        self.tokens = zi()
        self.active = torch.zeros((batch_size,), dtype=torch.bool,
                                  device=self.device)
        # last (token, pos) fed to each slot by the pool decode.
        # `tokens`/`pos` hold the *pending* decode input; inactive slots
        # re-feed their last-fed state each tick (an idempotent rewrite
        # for attention caches)
        self._ctok = zi()
        self._cpos = zi()
        # sampling state: per-slot request keys + #tokens already
        # generated (the fold index for the slot's next draw)
        self._slot_keys: list[tuple[int, ...]] = [self.key] * batch_size
        self._nout = [0] * batch_size
        # admission accounting: (rows x tokens) pushed through prefill
        # and chunk cells, and how many prefill cells ran
        self.admission_rowsteps = 0
        self.admission_prefills = 0
        # request latency tracking (wall), populated only when telemetry
        # is enabled
        self._t_submit: dict[int, float] = {}
        self._t_last_tok: dict[int, float] = {}
        # uids admitted-or-queued but not yet finished: a duplicate would
        # clobber the live request's TTFT accounting and collide its
        # sampling stream; reuse after finish is legal
        self._inflight: set[int] = set()

    # -- the cache and the page pool -----------------------------------------

    def _init_cache(self) -> Any:
        if self.paging is not None:
            return self.model.init_cache_paged(
                self.batch, self.paging.n_pages, self._page,
                device=self.device)
        return self.model.init_cache(self.batch, device=self.device)

    def _tbl_device(self, rows=slice(None)) -> torch.Tensor:
        return torch.as_tensor(self._tbl[rows]).to(self.device)

    def _compile_decode(self):
        probe = obs.get().probe
        if self._pg is None:
            return probe.track("serve.decode_step", self.model.decode_step)
        model, page = self.model, self._page
        cell = probe.track(
            "serve.decode_step",
            lambda p, c, t, pos, tbl: model.decode_step_paged(
                p, c, t, pos, tbl, page),
        )

        def step(params, cache, tok, pos):
            return cell(params, cache, tok, pos, self._tbl_device())

        return step

    # -- queue / admission --------------------------------------------------

    @driver_thread_only
    def submit(self, req: Request) -> None:
        if req.prompt.shape[0] == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        if req.max_new <= 0:
            # admission derives the first token from the prefill logits
            # unconditionally, so even max_new=0 would emit one token
            raise ValueError(
                f"request {req.uid}: max_new must be >= 1, "
                f"got {req.max_new}"
            )
        if req.uid in self._inflight:
            raise ValueError(
                f"request {req.uid}: uid already in flight — a "
                f"duplicate would clobber the live request's TTFT "
                f"accounting and collide its sampling stream; wait for "
                f"it to finish or submit under a fresh uid"
            )
        prompt = torch.as_tensor(req.prompt)
        if prompt.device.type == "cpu":
            # jnp clamps an out-of-range embedding index; torch raises (on
            # the card, a device-side assert that ends the process). Read
            # on the host only: a prompt already on the card is not waited
            # for here (the frontend's prompts arrive on the host)
            lo, hi = int(prompt.min()), int(prompt.max())
            if lo < 0 or hi >= self.model.dims.vocab:
                raise ValueError(
                    f"request {req.uid}: prompt token ids span [{lo}, {hi}],"
                    f" outside the vocabulary [0, {self.model.dims.vocab})"
                )
        s_len = int(req.prompt.shape[0])
        if not self.admissible(s_len, req.max_new):
            # never satisfiable: its worst-case page need exceeds the
            # whole usable pool, so no amount of waiting can ever seat it
            raise PagesExhaustedError(
                f"request {req.uid}: prompt {s_len} + max_new "
                f"{req.max_new} needs {self._worst_pages(s_len, req.max_new)}"
                f" pages, but the pool has only "
                f"{self._pg.usable_per_shard} usable"
            )
        self._inflight.add(req.uid)
        tel = obs.get()
        if tel.enabled:
            self._t_submit[req.uid] = time.perf_counter()
            tel.tracer.instant(
                "serve/submit", cat="serve",
                request_id=f"serve:{req.uid}",
                prompt_len=s_len,
            )
        self._queue.append(req)
        tel.registry.counter("serve.submitted_total").inc()

    def _worst_pages(self, prompt_len: int, max_new: int) -> int:
        """Worst-case pages a request can ever hold: prompt + max_new
        tokens write positions 0..prompt_len+max_new-2 (the last generated
        token is never fed back)."""
        return pages_for_position(
            prompt_len + max_new - 2, self._page, self._span
        )

    def admissible(self, prompt_len: int, max_new: int) -> bool:
        """False when the request can NEVER be seated (worst-case page need
        exceeds the whole usable pool). Host arithmetic only — safe
        to call from the frontend's event loop."""
        if self._pg is None:
            return True
        return (self._worst_pages(prompt_len, max_new)
                <= self._pg.usable_per_shard)

    def _pick_seat(self, req: Request, free: list) -> Optional[int]:
        """Claim a free slot (and, paged, reserve the request's worst-case
        pages). None when the pool cannot cover the reservation now:
        admission defers until running tenants free pages."""
        if self._pg is not None and not self._reserve(req):
            return None
        return free.pop(0)

    def _admit(self) -> None:
        # admission rounds: requests finishing at admission (EOS on
        # their first token) never occupy a slot, so their freed seats
        # go back into the next round on the same tick
        if self.chunk_tokens is not None:
            self._start_chunks()
        while self._queue:
            free = [i for i in range(self.batch) if self._slots[i] is None]
            if not free:
                return
            pairs = []
            blocked = False
            while self._queue and free:
                slot = self._pick_seat(self._queue[0], free)
                if slot is None:
                    # the page pool cannot cover the FIFO head yet: hold it
                    # (and everything behind it) until pages free up
                    blocked = True
                    break
                pairs.append((slot, self._queue.pop(0)))
            if not pairs:
                return
            groups: dict[int, list] = {}
            for slot, req in pairs:
                groups.setdefault(int(req.prompt.shape[0]), []).append(
                    (slot, req)
                )
            for s_len, grp in groups.items():
                self._admit_group(s_len, grp)
            if blocked:
                return

    def _admit_group(self, s_len: int, pairs: list) -> None:
        """One batched prefill + scatter-seat for same-length prompts."""
        tel = obs.get()
        tagged = (
            {"request_ids": [f"serve:{r.uid}" for _, r in pairs]}
            if tel.enabled
            else {}
        )
        with tel.span("serve/admit", cat="serve", s_len=s_len,
                      n=len(pairs), **tagged):
            self._admit_group_inner(tel, s_len, pairs, tagged)

    def _first_tokens(self, logits: torch.Tensor, reqs: list) -> list:
        """Each admitted request's first token from its prefill logits —
        the same source `generate` uses, which is what makes the two paths
        token-identical."""
        if self.greedy:
            return torch.argmax(logits, dim=-1).tolist()
        return sample_tokens(
            logits,
            [fold_in(request_key(self.key, r.uid), 0) for r in reqs],
            temperature=self.temperature, top_k=self.top_k,
        ).tolist()

    def _take_first(self, tel, req: Request, slot: int, first: int) -> bool:
        """Record a request's first token; True when that finishes it (EOS
        on the first token, or max_new 1): it must then never occupy the
        slot, and its page reservation is released."""
        req.output.append(first)
        if tel.enabled:
            t_now = time.perf_counter()
            t0 = self._t_submit.pop(req.uid, None)
            if t0 is not None:
                tel.registry.histogram("serve.ttft_s").observe(t_now - t0)
            self._t_last_tok[slot] = t_now
        if not ((req.eos is not None and first == req.eos)
                or len(req.output) >= req.max_new):
            return False
        req.done = True
        self._inflight.discard(req.uid)
        if self._pg is not None:
            self._pg.free(req.uid)  # releases the reservation
        self.active[slot] = False
        self._t_last_tok.pop(slot, None)
        if tel.enabled:
            tel.tracer.instant(
                "serve/finish", cat="serve",
                request_id=f"serve:{req.uid}",
                n_tokens=len(req.output),
                at_admission=True,
            )
        return True

    def _seat_rows(self, rows: Any, src: list, dst: list) -> None:
        if self._pg is not None:
            self.cache = self._seat(self.cache, rows, src, dst,
                                    self._tbl_device(dst))
        else:
            self.cache = self._seat(self.cache, rows, src, dst)

    def _admit_group_inner(self, tel, s_len: int, pairs: list,
                           tagged: dict) -> None:
        reqs = [r for _, r in pairs]
        n = len(reqs)
        prompts = torch.stack(
            [torch.as_tensor(r.prompt, dtype=torch.long) for r in reqs]
        ).to(self.device)
        with tel.span("serve/prefill", cat="serve", s_len=s_len, rows=n,
                      **tagged):
            logits, cache_rows = self._prefill(self.params, prompts)
            tel.block(logits)
        self.admission_rowsteps += n * s_len
        self.admission_prefills += 1
        tel.registry.counter("serve.admission_rowsteps").add(n * s_len)
        tel.registry.counter("serve.admission_prefills").inc()
        src, dst = [], []
        for j, ((slot, req), first) in enumerate(
                zip(pairs, self._first_tokens(logits, reqs))):
            if self._take_first(tel, req, slot, first):
                continue
            src.append(j)
            dst.append(slot)
            self._slots[slot] = req
            self._seat_slot_state(req, slot, s_len, first)
        if src:
            with tel.span("serve/seat", cat="serve", n=len(src), **tagged):
                self._seat_rows(cache_rows, src, dst)
                tel.block(leaves(self.cache))

    def _seat_slot_state(self, req: Request, slot: int, s_len: int,
                         first: int) -> None:
        """Per-slot engine state for a freshly seated request (batched
        admission and chunked-prefill completion). Paged: the prompt's
        pages are drawn from the request's reservation into the table
        before its cache rows are scattered."""
        if self._pg is not None:
            p0 = pages_for_position(s_len - 1, self._page, self._span)
            for j in range(p0):
                self._tbl[slot, j] = self._pg.alloc(req.uid)
            self._npages[slot] = p0
            self._hpos[slot] = s_len - 1
        self.pos[slot] = s_len - 1
        self.tokens[slot] = first
        self.active[slot] = True
        self._ctok[slot] = int(req.prompt[-1])
        self._cpos[slot] = s_len - 1
        self._slot_keys[slot] = request_key(self.key, req.uid)
        self._nout[slot] = 1

    # -- chunked prefill ----------------------------------------------------

    def _reserve(self, req: Request) -> bool:
        """Reserve the request's worst-case pages; False (nothing
        reserved) when the pool cannot cover them now."""
        worst = self._worst_pages(int(req.prompt.shape[0]), req.max_new)
        try:
            self._pg.reserve(req.uid, worst)
        except PagesExhaustedError:
            return False
        return True

    def _start_chunks(self) -> None:
        """Move long prompts off the admission queue into chunked prefill.
        Short prompts behind a long one admit normally — the starvation
        the chunk interleave exists to prevent. Requests whose page
        reservation cannot be covered yet park in `_chunk_wait` and retry
        each tick."""
        c = self.chunk_tokens
        longs = [r for r in self._queue if int(r.prompt.shape[0]) > c]
        if longs:
            self._queue = [r for r in self._queue
                           if int(r.prompt.shape[0]) <= c]
        tel = obs.get()
        for req in self._chunk_wait + longs:
            if self._pg is not None and not self._reserve(req):
                if req not in self._chunk_wait:
                    self._chunk_wait.append(req)
                continue
            if req in self._chunk_wait:
                self._chunk_wait.remove(req)
            # a fresh dense one-row cache for the chunk cell
            self._chunks.append(_ChunkState(
                req=req, cache=self.model.init_cache(1, device=self.device),
                done=0))
            if tel.enabled:
                tel.tracer.instant(
                    "serve/chunk_start", cat="serve",
                    request_id=f"serve:{req.uid}",
                    prompt_len=int(req.prompt.shape[0]),
                )

    def _chunk_tick(self, tel) -> int:
        """Advance every chunking request by one chunk; seat the ones that
        completed (free pool slot permitting). Returns the number of
        requests still mid-chunk or waiting — they count as engine
        activity, so `run()` and frontend drains do not stop early."""
        if self._chunk_wait:
            self._start_chunks()
        for st in list(self._chunks):
            if not st.ready:
                self._chunk_advance(tel, st)
            if st.ready and self._chunk_seat(tel, st):
                self._chunks.remove(st)
        return len(self._chunks) + len(self._chunk_wait)

    def _chunk_advance(self, tel, st: _ChunkState) -> None:
        prompt = torch.as_tensor(st.req.prompt, dtype=torch.long)
        lo = st.done
        hi = min(lo + self.chunk_tokens, prompt.shape[0])
        toks = prompt[lo:hi][None].to(self.device)
        poss = torch.arange(lo, hi, device=self.device)[None]
        with tel.span(
            "serve/chunk", cat="serve", lo=lo, hi=hi,
            **({"request_ids": [f"serve:{st.req.uid}"]}
               if tel.enabled else {}),
        ):
            st.logits, st.cache = self._chunk(self.params, st.cache, toks,
                                              poss, hi - lo)
            tel.block(st.logits)
        self.admission_rowsteps += hi - lo
        tel.registry.counter("serve.admission_rowsteps").add(hi - lo)
        tel.registry.counter("serve.chunk_steps").inc()
        st.done = hi
        st.ready = st.done >= prompt.shape[0]

    def _chunk_seat(self, tel, st: _ChunkState) -> bool:
        """Seat a completed chunked prefill into a free pool slot. First
        token, TTFT and the EOS-on-first-token guard mirror batched
        admission exactly."""
        req = st.req
        free = [i for i in range(self.batch) if self._slots[i] is None]
        if not free:
            return False
        slot = free[0]
        first = self._first_tokens(st.logits, [req])[0]
        if self._take_first(tel, req, slot, first):
            return True
        self._slots[slot] = req
        self._seat_slot_state(req, slot, int(req.prompt.shape[0]), first)
        with tel.span(
            "serve/seat", cat="serve", n=1, chunked=True,
            **({"request_ids": [f"serve:{req.uid}"]}
               if tel.enabled else {}),
        ):
            self._seat_rows(st.cache, [0], [slot])
            tel.block(leaves(self.cache))
        return True

    def _step_single(self, slot: int, token: int, pos: int) -> torch.Tensor:
        """Compatibility shim (the reference's replay admission ran prompts
        through this): feed one slot (token, pos) while every other slot
        re-feeds its last-fed state. Retransmitting a slot's last-fed
        (token, pos) is a bitwise no-op for attention caches — K/V writes
        depend only on (token, pos), not on the cache's contents."""
        self._ctok[slot] = token
        self._cpos[slot] = pos
        logits, self.cache = self._decode(self.params, self.cache,
                                          self._ctok, self._cpos)
        return logits

    @driver_thread_only
    def tick(self) -> int:
        """One decode tick for the whole pool; returns #active slots (plus
        requests mid chunked-prefill)."""
        tel = obs.get()
        with tel.span("serve/tick", cat="serve"):
            n_active = self._tick_inner(tel)
        tel.registry.gauge("serve.active_slots").set(n_active)
        return n_active

    def _map_pages(self) -> None:
        """Page-boundary crossings: every occupied slot writes position
        _hpos + 1 this tick, so any newly needed logical page is mapped
        before the decode cell sees the table (the seated reservation
        guarantees the alloc)."""
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            nw = self._hpos[slot] + 1
            need = pages_for_position(nw, self._page, self._span)
            while self._npages[slot] < need:
                self._tbl[slot, self._npages[slot]] = self._pg.alloc(req.uid)
                self._npages[slot] += 1
            self._hpos[slot] = nw

    def _tick_inner(self, tel) -> int:
        self._admit()
        n_chunk = (
            self._chunk_tick(tel) if self.chunk_tokens is not None else 0
        )
        if not any(r is not None for r in self._slots):
            return n_chunk
        if self._pg is not None:
            self._map_pages()
        # active slots advance with their pending token; inactive slots
        # re-feed their last-fed state
        pos = torch.where(self.active, self.pos + 1, self._cpos)
        toks = torch.where(self.active, self.tokens, self._ctok)
        tagged = (
            {"request_ids": [
                f"serve:{r.uid}" for r in self._slots if r is not None
            ]}
            if tel.enabled
            else {}
        )
        with tel.span("serve/decode", cat="serve", **tagged):
            logits, self.cache = self._decode(self.params, self.cache, toks,
                                              pos)
            if self.greedy:
                nxt = torch.argmax(logits, dim=-1)
            else:
                nxt = sample_tokens(
                    logits,
                    [fold_in(k, t) for k, t in zip(self._slot_keys,
                                                   self._nout)],
                    temperature=self.temperature, top_k=self.top_k,
                )
            tel.block(nxt)
        # this decode fed (toks, pos) into every slot's cache
        self._ctok = toks
        self._cpos = pos
        self.pos = torch.where(self.active, pos, self.pos)
        self.tokens = torch.where(self.active, nxt, self.tokens)
        n_active = 0
        for slot, (req, tok) in enumerate(zip(self._slots, nxt.tolist())):
            if req is None:
                continue
            self._nout[slot] += 1
            req.output.append(tok)
            if tel.enabled:
                t_now = time.perf_counter()
                t_prev = self._t_last_tok.get(slot)
                if t_prev is not None:
                    tel.registry.histogram("serve.inter_token_s").observe(
                        t_now - t_prev)
                self._t_last_tok[slot] = t_now
            tel.registry.counter("serve.tokens_total").inc()
            if (req.eos is not None and tok == req.eos) or len(
                req.output
            ) >= req.max_new:
                req.done = True
                self._inflight.discard(req.uid)
                self._slots[slot] = None
                self.active[slot] = False
                self._t_last_tok.pop(slot, None)
                if self._pg is not None:
                    # return the slot's pages and point its table row back
                    # at scratch: the pool decode re-feeds inactive slots
                    # every tick, and scratch is the only page those
                    # writes may scribble on
                    self._pg.free(req.uid)
                    self._tbl[slot, :] = self._pg.scratch()
                    self._npages[slot] = 0
                tel.registry.counter("serve.completed_total").inc()
                if tel.enabled:
                    tel.tracer.instant(
                        "serve/finish", cat="serve",
                        request_id=f"serve:{req.uid}",
                        n_tokens=len(req.output),
                    )
            else:
                n_active += 1
        return n_active + n_chunk

    def cache_bytes_in_use(self) -> int:
        """Logically resident cache bytes: occupied slots' dense per-slot
        state plus (paged) allocated pages. Drains back to the
        post-construction value (0) when every request finishes. The dense
        pool counts full `max_seq` rows per tenant; the paged pool counts
        only mapped pages."""
        slot_b, page_b = self._cache_byte_model()
        used = sum(r is not None for r in self._slots) * slot_b
        if self._pg is not None:
            used += self._pg.allocated_pages() * page_b
        return used

    def _cache_byte_model(self) -> tuple[int, int]:
        """(bytes per occupied slot over dense leaves, bytes per page over
        paged pool leaves), from the live cache tree."""
        if getattr(self, "_byte_model", None) is None:
            slot_b = page_b = 0
            for parts, leaf in seating._leaf_paths(self.cache):
                nbytes = leaf.numel() * leaf.element_size()
                if (self._pg is not None
                        and seating._leaf_layout(parts, self._layouts)
                        is not None):
                    page_b += nbytes // self.paging.n_pages
                else:
                    slot_b += nbytes // leaf.shape[
                        seating.cache_batch_axis(parts)]
            self._byte_model = (slot_b, page_b)
        return self._byte_model

    @driver_thread_only
    def run(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if self.tick() == 0 and not self._queue:
                break


def generate(
    model: Model,
    params: Any,
    prompts: torch.Tensor,  # (B, S) int — same-length batch
    *,
    max_new: int,
    greedy: bool = True,
    key: Optional[tuple[int, ...]] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    device: _device.DeviceLike = None,
) -> torch.Tensor:
    """Simple batched generate: one prefill + max_new decode steps, on
    `device` (`None` means the CUDA card; `params` must be there).
    Returns (B, max_new) int64.

    With `greedy=False` and a `key`, row b's token t is drawn with
    `fold_in(request_key(key, b), t)` — the engine's per-request schedule
    with the row index as uid, so a request submitted to an `Engine`
    built on the same key (uid == row) produces the same stream."""
    _reject_enc_dec(model.cfg, "generate")
    dev = _device.resolve(device)
    prompts = torch.as_tensor(prompts, dtype=torch.long).to(dev)
    b, s = prompts.shape
    sampling = not greedy and key is not None
    last_logits, cache = model.prefill(params, prompts)

    def draw(logits, t):
        if not sampling:
            return torch.argmax(logits, dim=-1)
        return sample_tokens(
            logits, [fold_in(request_key(key, r), t) for r in range(b)],
            temperature=temperature, top_k=top_k,
        )

    tok = draw(last_logits, 0)
    outs = []
    for t in range(max_new):
        outs.append(tok)
        pos = torch.full((b,), s + t, dtype=torch.long, device=dev)
        logits, cache = model.decode_step(params, cache, tok, pos)
        tok = draw(logits, t + 1)
    return torch.stack(outs, dim=1)

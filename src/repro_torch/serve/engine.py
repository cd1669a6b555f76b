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

Not ported yet: `paging=` and `chunk_tokens=` (ROADMAP.md queue 1 item 7)
raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.serve.paging import PagingConfig


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


class Engine:
    """Slot-based batched decoder around a Model, on one device (`None`
    means the CUDA card; `params` must be there).

    Admission is batched: each round takes up to |free slots| queued
    requests, groups them by prompt length, runs one `model.prefill` per
    group, and scatter-seats the resulting cache rows into the pool
    (`serve.seating.scatter_slots`). `admission_rowsteps` counts the
    (row x token) units actually spent, `admission_prefills` the prefill
    cells run.
    """

    def __init__(self, model: Model, params: Any, *, batch_size: int,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, key: Optional[tuple[int, ...]] = None,
                 paging: Optional[PagingConfig] = None,
                 chunk_tokens: Optional[int] = None,
                 device: _device.DeviceLike = None):
        if paging is not None or chunk_tokens is not None:
            raise NotImplementedError(
                "the paged cache and chunked prefill are not ported yet "
                "(ROADMAP.md queue 1 item 7)"
            )
        _reject_enc_dec(model.cfg, "the slot engine")
        self.device = _device.resolve(device)
        self.model = model
        self.params = params
        self.batch = batch_size
        self.greedy = greedy
        self.temperature = temperature
        self.top_k = top_k
        self.key = key if key is not None else prng_key(0)
        probe = obs.get().probe
        self._decode = probe.track("serve.decode_step", model.decode_step)
        self._prefill = probe.track("serve.prefill", model.prefill)
        self._seat = probe.track("serve.seat", seating.scatter_slots)
        self._queue: list[Request] = []
        self._slots: list[Optional[Request]] = [None] * batch_size
        self.cache = model.init_cache(batch_size, device=self.device)

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
        # cells, and how many cells ran
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
        self._inflight.add(req.uid)
        tel = obs.get()
        if tel.enabled:
            self._t_submit[req.uid] = time.perf_counter()
            tel.tracer.instant(
                "serve/submit", cat="serve",
                request_id=f"serve:{req.uid}",
                prompt_len=int(req.prompt.shape[0]),
            )
        self._queue.append(req)
        tel.registry.counter("serve.submitted_total").inc()

    def _admit(self) -> None:
        # admission rounds: requests finishing at admission (EOS on
        # their first token) never occupy a slot, so their freed seats
        # go back into the next round on the same tick
        while self._queue:
            free = [i for i in range(self.batch) if self._slots[i] is None]
            if not free:
                return
            pairs = []
            while self._queue and free:
                pairs.append((free.pop(0), self._queue.pop(0)))
            groups: dict[int, list] = {}
            for slot, req in pairs:
                groups.setdefault(int(req.prompt.shape[0]), []).append(
                    (slot, req)
                )
            for s_len, grp in groups.items():
                self._admit_group(s_len, grp)

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
        # the first generated token comes from the prefill's final
        # logits — the same source `generate` uses, which is what makes
        # the two paths token-identical
        if self.greedy:
            firsts = torch.argmax(logits, dim=-1)
        else:
            firsts = sample_tokens(
                logits,
                [fold_in(request_key(self.key, r.uid), 0) for r in reqs],
                temperature=self.temperature, top_k=self.top_k,
            )
        src, dst = [], []
        for j, ((slot, req), first) in enumerate(zip(pairs, firsts.tolist())):
            req.output.append(first)
            if tel.enabled:
                t_now = time.perf_counter()
                t0 = self._t_submit.pop(req.uid, None)
                if t0 is not None:
                    tel.registry.histogram("serve.ttft_s").observe(t_now - t0)
                self._t_last_tok[slot] = t_now
            if (
                req.eos is not None and first == req.eos
            ) or len(req.output) >= req.max_new:
                # EOS-on-first-token guard: the request finishes at
                # admission and must never occupy the slot
                req.done = True
                self._inflight.discard(req.uid)
                self.active[slot] = False
                self._t_last_tok.pop(slot, None)
                if tel.enabled:
                    tel.tracer.instant(
                        "serve/finish", cat="serve",
                        request_id=f"serve:{req.uid}",
                        n_tokens=len(req.output),
                        at_admission=True,
                    )
                continue
            src.append(j)
            dst.append(slot)
            self._slots[slot] = req
            self._seat_slot_state(req, slot, s_len, first)
        if src:
            with tel.span("serve/seat", cat="serve", n=len(src), **tagged):
                self.cache = self._seat(self.cache, cache_rows, src, dst)
                tel.block(leaves(self.cache))

    def _seat_slot_state(self, req: Request, slot: int, s_len: int,
                         first: int) -> None:
        """Per-slot engine state for a freshly seated request."""
        self.pos[slot] = s_len - 1
        self.tokens[slot] = first
        self.active[slot] = True
        self._ctok[slot] = int(req.prompt[-1])
        self._cpos[slot] = s_len - 1
        self._slot_keys[slot] = request_key(self.key, req.uid)
        self._nout[slot] = 1

    @driver_thread_only
    def tick(self) -> int:
        """One decode tick for the whole pool; returns #active slots."""
        tel = obs.get()
        with tel.span("serve/tick", cat="serve"):
            n_active = self._tick_inner(tel)
        tel.registry.gauge("serve.active_slots").set(n_active)
        return n_active

    def _tick_inner(self, tel) -> int:
        self._admit()
        if not any(r is not None for r in self._slots):
            return 0
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
                tel.registry.counter("serve.completed_total").inc()
                if tel.enabled:
                    tel.tracer.instant(
                        "serve/finish", cat="serve",
                        request_id=f"serve:{req.uid}",
                        n_tokens=len(req.output),
                    )
            else:
                n_active += 1
        return n_active

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

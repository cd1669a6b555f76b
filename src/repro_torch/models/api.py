"""Unified model API: every architecture behind one interface.

Port of `repro.models.api`. `build_model(cfg, tp)` returns a `Model`
whose entry points are what the server drives:

    init(seed, device=None)        -> params (drawn on the device)
    prefill(params, tokens)        -> (last_logits, cache)
        (encoder-decoder: prefill(params, tokens, frames))
    decode_step(params, cache, token, pos) -> (logits, cache)
    init_cache(batch, device=None) -> cache tree
    loss(params, batch)            -> (loss, metrics): next-token CE
                                      (+ MoE aux); batch {"tokens",
                                      "targets"[, "frames"]}

and, for the decoder-only stack, the paged serving cache (None for the
encoder-decoder model, as in the reference):

    init_cache_paged(batch, n_pages, page, device=None) -> cache with
                                      K/V page pools
    decode_step_paged(params, cache, token, pos, page_tbl, page)
                                   -> (logits, cache)
    page_layouts(page)             -> {attn cache path prefix:
                                      (pages_per_slot, page)}
    attn_capacities()              -> per-attention-block capacities

`device=None` means the CUDA card, as everywhere in the port. The
decode step updates the cache in place (`models.transformer`,
`models.whisper`).

`input_specs(cfg, cell)` gives the dry-run's abstract inputs of one (arch
x shape) cell: "meta" tensors, which hold a shape and a dtype and no
storage, in place of the reference's `ShapeDtypeStruct`s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import _device
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W

# block kinds whose decode cache advances on every step (hidden-state
# recurrences), as opposed to position-indexed attention KV writes. The
# serving engine seats both by per-slot cache scatter (`serve.seating`);
# replaying a (token, pos) is idempotent for attention caches only.
RECURRENT_KINDS = ("rglru", "rwkv")


def block_kinds(cfg: ArchConfig) -> tuple[str, ...]:
    """Every block kind the stack instantiates (pattern + tail)."""
    return tuple(cfg.pattern) + tuple(cfg.tail or ())


def is_recurrent(cfg: ArchConfig) -> bool:
    """True when any block carries a step-advancing recurrent cache."""
    return any(k in RECURRENT_KINDS for k in block_kinds(cfg))


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    dims: T.Dims
    max_seq: int
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., tuple[torch.Tensor, Any]]
    decode_step: Callable[..., tuple[torch.Tensor, Any]]
    init_cache: Callable[..., Any]
    init_cache_paged: Optional[Callable[..., Any]] = None
    decode_step_paged: Optional[Callable[..., tuple[torch.Tensor, Any]]] = None
    page_layouts: Optional[Callable[[int], dict]] = None
    attn_capacities: Optional[Callable[[], tuple[int, ...]]] = None


def build_model(cfg: ArchConfig, *, tp: int = 1, max_seq: int = 4096) -> Model:
    cfg.validate()
    dims = T.Dims.create(cfg, tp)

    def generator(seed: int, device: _device.DeviceLike) -> torch.Generator:
        return torch.Generator(device=_device.resolve(device)).manual_seed(seed)

    if cfg.is_enc_dec:
        return Model(
            cfg=cfg,
            dims=dims,
            max_seq=max_seq,
            init=lambda seed, device=None: W.whisper_init(
                generator(seed, device), cfg, dims, max_seq),
            loss=lambda p, batch: W.loss_fn(p, batch, cfg, dims),
            prefill=lambda p, tokens, frames: W.prefill(
                p, tokens, frames, cfg, dims, max_seq=max_seq
            ),
            decode_step=lambda p, cache, token, pos: W.decode_step(
                p, cache, token, pos, cfg, dims
            ),
            init_cache=lambda batch, device=None: W.init_cache(
                cfg, dims, batch, max_seq, _device.resolve(device)
            ),
        )

    return Model(
        cfg=cfg,
        dims=dims,
        max_seq=max_seq,
        init=lambda seed, device=None: T.stack_init(
            generator(seed, device), cfg, dims),
        loss=lambda p, batch: T.loss_fn(p, batch, cfg, dims),
        prefill=lambda p, tokens: T.prefill(
            p, tokens, cfg, dims, max_seq=max_seq
        ),
        decode_step=lambda p, cache, token, pos: T.decode_step(
            p, cache, token, pos, cfg, dims
        ),
        init_cache=lambda batch, device=None: T.init_cache(
            cfg, dims, batch, max_seq, _device.resolve(device)
        ),
        init_cache_paged=lambda batch, n_pages, page, device=None: (
            T.init_cache_paged(cfg, dims, batch, n_pages, page, max_seq,
                               _device.resolve(device))
        ),
        decode_step_paged=lambda p, cache, token, pos, tbl, page: (
            T.decode_step(p, cache, token, pos, cfg, dims, page_tbl=tbl,
                          page=page)
        ),
        page_layouts=lambda page: T.paged_layouts(cfg, page, max_seq),
        attn_capacities=lambda: T.attn_capacities(cfg, max_seq),
    )


# ---------------------------------------------------------------------------
# Abstract inputs for the dry-run
# ---------------------------------------------------------------------------

_META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def input_specs(
    cfg: ArchConfig, cell: ShapeCell, *, tp: int = 1
) -> dict[str, Any]:
    """"meta"-tensor stand-ins for one (arch x shape) cell, the
    reference's structure, shapes and dtypes (token ids int32, as the
    reference's); nothing is allocated.

    train  -> {"batch": {...}}                         for model.loss
    prefill-> {"tokens": ..., ("frames": ...)}         for model.prefill
    decode -> {"cache": ..., "token": ..., "pos": ...} for model.decode_step
    """
    b, s = cell.global_batch, cell.seq_len
    model = build_model(cfg, tp=tp, max_seq=s)
    dt = T.compute_dtype(cfg)
    if cell.kind == "train":
        batch: dict[str, Any] = {
            "tokens": _spec((b, s), torch.int32),
            "targets": _spec((b, s), torch.int32),
        }
        if cfg.is_enc_dec:
            batch["frames"] = _spec((b, cfg.enc_seq, cfg.d_model), dt)
        return {"batch": batch}
    if cell.kind == "prefill":
        out: dict[str, Any] = {"tokens": _spec((b, s), torch.int32)}
        if cfg.is_enc_dec:
            out["frames"] = _spec((b, cfg.enc_seq, cfg.d_model), dt)
        return out
    return {
        "cache": model.init_cache(b, device=_META),
        "token": _spec((b,), torch.int32),
        "pos": _spec((b,), torch.int32),
    }

"""Unified model API: every ported architecture behind one interface.

Port of `repro.models.api`. `build_model(cfg, tp)` returns a `Model`
whose entry points are what the server drives:

    init(seed, device=None)        -> params (drawn on the device)
    prefill(params, tokens)        -> (last_logits, cache)
    decode_step(params, cache, token, pos) -> (logits, cache)
    init_cache(batch, device=None) -> cache tree
    loss(params, batch)            -> raises: LM training is ROADMAP.md
                                      queue 1 item 10

`device=None` means the CUDA card, as everywhere in the port. The
decode step updates the cache in place (`models.transformer`). The
dry-run's `input_specs` is not ported (ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import _device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T

# block kinds whose decode cache advances on every step (hidden-state
# recurrences), as opposed to position-indexed attention KV writes
RECURRENT_KINDS = ("rglru", "rwkv")


class EncDecUnsupportedError(TypeError):
    """An encoder-decoder (whisper-family) config reached the port, which
    has only the decoder-only stack so far (ROADMAP.md queue 1 item 6)."""


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


def build_model(cfg: ArchConfig, *, tp: int = 1, max_seq: int = 4096) -> Model:
    """Raises EncDecUnsupportedError for an encoder-decoder config and
    NotImplementedError for the families this port does not have yet."""
    cfg.validate()
    if cfg.is_enc_dec:
        raise EncDecUnsupportedError(
            f"{cfg.name!r} is an encoder-decoder model; the whisper stack is "
            f"not ported yet ({T.FAMILIES_ITEM})"
        )
    T.check_supported(cfg)
    dims = T.Dims.create(cfg, tp)

    def init(seed: int, device: _device.DeviceLike = None) -> dict:
        dev = _device.resolve(device)
        return T.stack_init(
            torch.Generator(device=dev).manual_seed(seed), cfg, dims)

    return Model(
        cfg=cfg,
        dims=dims,
        max_seq=max_seq,
        init=init,
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
    )

"""Synthetic LM token pipeline (deterministic, host-sharded).

Port of `repro.data.lm`: the same contract as a production pipeline —
deterministic batch-at-step addressing (exact restart after failure),
disjoint per-host shards, and the {tokens, targets} next-token schema the
trainer consumes. The content is a random walk over the vocabulary with
5% uniform noise: local statistics a model can learn, cheap to draw.

A `torch.Generator` gives other numbers than the reference's jax PRNG for
the same seed, so `synth_tokens` is split into the draws (`draw_walk`)
and a pure assembly (`assemble_walk`): the tests feed both packages'
assemblies the same numpy draws. `batch_at` keys a fresh generator on the
stream's device by (seed, host_id, step), as `data.iegm.IEGMStream`
does.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from repro_torch import _device
from repro_torch.data.iegm import _stream_seed

NOISE_P = 0.05  # share of uniform-random tokens (the loss's noise floor)
MAX_STEP = 8  # the walk moves by -MAX_STEP..MAX_STEP a token


def draw_walk(
    gen: torch.Generator, batch: int, seq_len: int, vocab: int
) -> dict[str, torch.Tensor]:
    """The random draws of one walk batch, on `gen`'s device: `steps`
    (B, S) in [-8, 8], `start` (B, 1) and `noise` (B, S) in [0, vocab),
    and the `is_noise` (B, S) mask, each drawn apart so they stay
    uncorrelated."""
    dev = gen.device

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    return {
        "steps": ints(-MAX_STEP, MAX_STEP + 1, (batch, seq_len)),
        "start": ints(0, vocab, (batch, 1)),
        "noise": ints(0, vocab, (batch, seq_len)),
        "is_noise": torch.rand((batch, seq_len), generator=gen,
                               device=dev) < NOISE_P,
    }


def assemble_walk(
    steps: torch.Tensor, start: torch.Tensor, noise: torch.Tensor,
    is_noise: torch.Tensor, vocab: int,
) -> torch.Tensor:
    """(start + cumsum(steps)) mod vocab, with the noise tokens where
    `is_noise`; int32 (B, S). The modulus is floor-mod, as jnp's `%`: the
    cumulative sum goes negative."""
    walk = torch.remainder(start + torch.cumsum(steps, dim=1), vocab)
    return torch.where(is_noise, noise, walk).to(torch.int32)


def synth_tokens(
    gen: torch.Generator, batch: int, seq_len: int, vocab: int
) -> torch.Tensor:
    """Structured token stream: a random walk over a banded vocabulary
    with 5% uniform noise — learnable local (bigram-ish) statistics."""
    return assemble_walk(**draw_walk(gen, batch, seq_len, vocab), vocab=vocab)


def batch_at(
    seed: int, step: int, *, batch: int, seq_len: int, vocab: int,
    host_id: int = 0, device: _device.DeviceLike = None,
) -> dict[str, torch.Tensor]:
    """{tokens (B, S), targets (B, S)} int32 on `device` (`None` means the
    CUDA card) — targets are the next-token shift."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(_stream_seed(seed, host_id, step))
    toks = synth_tokens(gen, batch, seq_len + 1, vocab)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@dataclasses.dataclass
class TokenStream:
    """Deterministic host-sharded stream. `batch` is the *per-host* size;
    `device=None` means the CUDA card (the stream raises at construction
    when there is none)."""

    batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    host_id: int = 0
    device: _device.DeviceLike = None

    def __post_init__(self):
        self.device = _device.resolve(self.device)

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        return batch_at(
            self.seed, step, batch=self.batch, seq_len=self.seq_len,
            vocab=self.vocab, host_id=self.host_id, device=self.device,
        )

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

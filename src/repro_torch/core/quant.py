"""Mixed-bit-width quantization — the CMUL arithmetic, as math.

Port of `repro.core.quant`: symmetric per-channel quantization
(`quantize` / `dequantize`), the straight-through fake-quant used in
QAT, and the packed uint8 bit-plane storage (`pack_planes` /
`unpack_planes`) the compiler writes into each `CompiledLayer`.

Bit-exactness with the reference: `torch.round` rounds half to even like
`jnp.round`, and `w / scale` is the same float32 division, so the int8
codes come out identical.
"""

from __future__ import annotations

import dataclasses

import torch

SUPPORTED_BITS = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Per-tensor quantization configuration.

    Attributes:
      bits: bit width of the stored weights (1, 2, 4 or 8).
      per_channel: one scale per output channel (last dim) instead of one
        per tensor.
      narrow_range: clamp to [-(2^{b-1}-1), 2^{b-1}-1] (symmetric, as the
        chip's signed arithmetic) instead of the full two's-complement
        range.
    """

    bits: int = 8
    per_channel: bool = True
    narrow_range: bool = True

    def __post_init__(self):
        if self.bits not in SUPPORTED_BITS:
            raise ValueError(
                f"bits must be one of {SUPPORTED_BITS}, got {self.bits}"
            )

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1 if self.bits > 1 else 1

    @property
    def qmin(self) -> int:
        if self.bits == 1:
            return -1
        if self.narrow_range:
            return -self.qmax
        return -(1 << (self.bits - 1))


_TINY = torch.finfo(torch.float32).tiny


def _channel_reduce(w: torch.Tensor, fn, cfg: QuantConfig) -> torch.Tensor:
    """`fn` over every axis but the last (per channel, keepdim) or over
    the whole tensor."""
    if cfg.per_channel and w.ndim >= 2:
        return fn(w, dim=tuple(range(w.ndim - 1)), keepdim=True)
    return fn(w)


def quantize(
    w: torch.Tensor, cfg: QuantConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize to signed integers; returns (q int8, scale float32).

    1-bit is binary-connect style: sign(w) in {-1, +1} with scale mean|w|.
    Fully-zero channels are guarded by float32's smallest normal; where
    that guard divided by qmax is subnormal (4 and 8 bits), the stored
    scale is flushed to 0, as XLA flushes it in the reference.
    """
    w = w.to(torch.float32)
    if cfg.bits == 1:
        scale = _channel_reduce(w.abs(), torch.mean, cfg).clamp_min(_TINY)
        q = torch.where(w >= 0, 1, -1).to(torch.int8)
        return q, scale
    amax = _channel_reduce(w.abs(), torch.amax, cfg).clamp_min(_TINY)
    scale = amax / cfg.qmax
    # codes first: 0 / subnormal is code 0, the reference's code
    q = torch.clamp(torch.round(w / scale), cfg.qmin, cfg.qmax)
    scale = torch.where(scale < _TINY, 0.0, scale)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize forward, identity (straight-through) backward."""

    @staticmethod
    def forward(ctx, w, bits, per_channel):
        q, scale = quantize(w, QuantConfig(bits=bits, per_channel=per_channel))
        return dequantize(q, scale).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fake_quant(w: torch.Tensor, bits: int, per_channel: bool) -> torch.Tensor:
    """Quantize-dequantize with a straight-through estimator (for QAT)."""
    return _FakeQuant.apply(w, bits, per_channel)


# ---------------------------------------------------------------------------
# Packed storage (what the chip stores; 8/bits values per byte along K)
# ---------------------------------------------------------------------------


def pack_planes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack a signed int8 (K, N) weight into uint8 words along K.

    Each byte holds 8/bits consecutive K entries, least significant
    first, as two's-complement `bits`-bit fields; 1-bit stores {-1,+1}
    as {0,1}. Output shape (ceil(K*bits/8), N).
    """
    if q.ndim != 2:
        raise ValueError("pack_planes expects a 2-D (K, N) weight")
    k, n = q.shape
    vals_per_byte = 8 // bits
    pad = (-k) % vals_per_byte
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad))
    if bits == 1:
        u = (q > 0).to(torch.int32)
    else:
        u = q.to(torch.int32) & ((1 << bits) - 1)
    u = u.reshape(-1, vals_per_byte, n)
    shifts = (
        torch.arange(vals_per_byte, dtype=torch.int32, device=q.device) * bits
    ).reshape(1, -1, 1)
    return (u << shifts).sum(dim=1).to(torch.uint8)


def unpack_planes(packed: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Inverse of `pack_planes`: uint8 (K/vpb, N) -> signed int8 (K, N)."""
    vals_per_byte = 8 // bits
    mask = (1 << bits) - 1
    n = packed.shape[-1]
    shifts = (
        torch.arange(vals_per_byte, dtype=torch.int32, device=packed.device)
        * bits
    ).reshape(1, -1, 1)
    u = (packed.to(torch.int32)[:, None, :] >> shifts) & mask
    u = u.reshape(-1, n)[:k]
    if bits == 1:
        return torch.where(u > 0, 1, -1).to(torch.int8)
    sign_bit = 1 << (bits - 1)
    return torch.where(u >= sign_bit, u - (1 << bits), u).to(torch.int8)

"""Shape plumbing shared by the kernel wrappers, and the plain forms of the
in-kernel weight unpacking and decompression (port of
`repro.kernels._common`).

The reference's `pad_to` has no counterpart: the CUDA kernels mask their
ragged edges themselves instead of taking tile-padded operands.
"""

from __future__ import annotations

import math

import torch


def flatten_batch(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    """(..., K) -> ((M, K), leading_shape) for 2-D kernel entry."""
    lead = tuple(x.shape[:-1])
    return x.reshape(math.prod(lead), x.shape[-1]), lead


def unpack_tile(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 (Kp, N) packed words -> signed int32 (Kp*vpb, N).

    Each byte holds vpb = 8/bits two's-complement fields, least
    significant first along K (`core.quant.pack_planes`); 1-bit fields
    decode {0,1} -> {-1,+1}. No slicing to a K: every field is returned.
    """
    vpb = 8 // bits
    mask = (1 << bits) - 1
    kp, n = packed.shape
    shifts = (
        torch.arange(vpb, dtype=torch.int32, device=packed.device) * bits
    ).reshape(1, vpb, 1)
    u = (packed.to(torch.int32)[:, None, :] >> shifts) & mask
    u = u.reshape(kp * vpb, n)
    if bits == 1:
        return torch.where(u > 0, 1, -1).to(torch.int32)
    sign_bit = 1 << (bits - 1)
    return torch.where(u >= sign_bit, u - (1 << bits), u)


def decompress_tile(
    values: torch.Tensor, select: torch.Tensor, group_size: int, keep: int
) -> torch.Tensor:
    """(Kk, N) values+select -> dense float32 (Kk//keep*G, N).

    The TPU kernel rebuilds the tile with a one-hot compare against an
    in-group iota; here a scatter does the same (select cast to int64: a
    uint8 index would be read as a boolean mask).
    """
    kk, n = values.shape
    groups = kk // keep
    vals = values.reshape(groups, keep, n).to(torch.float32)
    sel = select.reshape(groups, keep, n).to(torch.int64)
    dense = torch.zeros(
        (groups, group_size, n), dtype=torch.float32, device=values.device
    )
    return dense.scatter_(1, sel, vals).reshape(groups * group_size, n)

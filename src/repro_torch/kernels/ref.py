"""Plain oracles of the port's kernels (port of `repro.kernels.ref`).

Each function is the semantic definition of its kernel: small, obviously
correct and memory-naive. The tests hold the kernels' wrappers to them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import quant as Q
from repro_torch.core import sparsity as S
from repro_torch.core.spe import im2col


def nm_spmm_ref(
    x: torch.Tensor,
    values: torch.Tensor,
    select: torch.Tensor,
    scale: Optional[torch.Tensor],
    *,
    group_size: int,
    keep: int,
) -> torch.Tensor:
    """y[..., n] = sum_r values[r, n] * x[..., (r//keep)*G + select[r, n]].

    ``values`` may be int8 (with per-channel ``scale``) or float
    (``scale=None``). Output is float32.
    """
    cfg = S.SparsityConfig(group_size, keep)
    y = S.sparse_matmul_ref(
        x.to(torch.float32), values.to(torch.float32), select, cfg
    )
    if scale is not None:
        y = y * scale.reshape((1,) * (y.ndim - 1) + (-1,))
    return y


def quant_matmul_ref(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    *,
    bits: int,
    k: int,
) -> torch.Tensor:
    """y = x @ (unpack(packed) * scale). Output float32."""
    q = Q.unpack_planes(packed, bits, k).to(torch.float32)
    y = x.to(torch.float32) @ q
    return y * scale.reshape((1,) * (y.ndim - 1) + (-1,))


def sparse_conv1d_ref(
    x: torch.Tensor,
    values: torch.Tensor,
    select: torch.Tensor,
    scale: Optional[torch.Tensor],
    *,
    ksize: int,
    stride: int,
    group_size: int,
    keep: int,
) -> torch.Tensor:
    """(B, T, C) -> (B, T_out, N) sparse-quantized conv, SAME padding.

    The contraction dim is the flattened (ksize * C) window, zero-padded to
    a whole number of sparsity groups — exactly what `core.compiler` emits.
    """
    patches = im2col(x, ksize, stride)
    k_dense = (values.shape[0] // keep) * group_size
    if patches.shape[-1] < k_dense:
        patches = F.pad(patches, (0, k_dense - patches.shape[-1]))
    return nm_spmm_ref(
        patches, values, select, scale, group_size=group_size, keep=keep
    )

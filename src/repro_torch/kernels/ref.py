"""Plain oracles of the port's kernels (port of `repro.kernels.ref`).

Each function is the semantic definition of its kernel: small, obviously
correct and memory-naive. The tests hold the kernels' wrappers to them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import sparsity as S


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

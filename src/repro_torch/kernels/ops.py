"""Public wrappers of the port's kernels (port of `repro.kernels.ops`).

They flatten batch dimensions, default the scale, and dispatch by the
tensor's device: a CPU tensor takes the kernel's plain PyTorch version, a
CUDA tensor launches the hand-written kernel or raises. There is no
fallback from one to the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import nm_spmm as _nm_spmm
from repro_torch.kernels._common import flatten_batch


def nm_spmm(
    x: torch.Tensor,
    values: torch.Tensor,
    select: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    *,
    group_size: int,
    keep: int,
) -> torch.Tensor:
    """Balanced select-index sparse matmul (..., K) x (Kk, N) -> (..., N) f32.

    K (the dense contraction of `x`) must equal (Kk // keep) * group_size:
    `x` is already group-padded, as `core.compiler` guarantees.
    """
    kk, n = values.shape
    x2, lead = flatten_batch(x)
    k = x2.shape[1]
    if keep <= 0 or kk % keep or k != (kk // keep) * group_size:
        raise ValueError(
            f"K={k}, Kk={kk} inconsistent with {keep}:{group_size} sparsity"
        )
    if scale is None:
        scale = torch.ones((1, n), dtype=torch.float32, device=x.device)
    sc = scale.reshape(1, n).to(torch.float32)
    if x.device.type == "cpu":
        y = _nm_spmm.nm_spmm_plain(
            x2, values, select, sc, group_size=group_size, keep=keep
        )
    elif x.device.type == "cuda":
        y = _nm_spmm.nm_spmm_cuda(
            x2.to(torch.float32).contiguous(), values.contiguous(),
            select.contiguous(), sc.contiguous(),
            group_size=group_size, keep=keep,
        )
    else:
        raise ValueError(f"nm_spmm has no kernel for device {x.device}")
    return y.reshape(*lead, n)

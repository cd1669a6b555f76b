"""Public wrappers of the port's kernels (port of `repro.kernels.ops`).

The matmuls flatten batch dimensions; every wrapper checks its geometry,
defaults the scale, and dispatches by the tensor's device: a CPU tensor takes the kernel's plain PyTorch version, a
CUDA tensor launches the hand-written kernel or raises. There is no
fallback from one to the other.

A launch is invisible to PyTorch's dispatcher (the kernels are called
through `ctypes`), so each wrapper reports its own: the flops of the work
the kernel does and the bytes it must move (each input read once, the
output written once), into any call record open on the thread
(`obs.torchprobe.add_kernel_cost`, read by `cost_gauges` and the cell
auditor).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import bitserial as _bitserial
from repro_torch.kernels import nm_spmm as _nm_spmm
from repro_torch.kernels import quant_matmul as _quant_matmul
from repro_torch.kernels import sparse_conv1d as _sparse_conv1d
from repro_torch.kernels._common import flatten_batch
from repro_torch.obs.torchprobe import add_kernel_cost


def _scale(scale: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    """The (1, N) float32 scale, ones where none is given."""
    if scale is None:
        return torch.ones((1, n), dtype=torch.float32, device=device)
    return scale.reshape(1, n).to(torch.float32)


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
    sc = _scale(scale, n, x.device)
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
        m = x2.shape[0]
        add_kernel_cost(_nm_spmm.NAME, 2 * m * kk * n,
                        m * k * 4 + kk * n * 2 + n * 4 + m * n * 4)
    else:
        raise ValueError(f"nm_spmm has no kernel for device {x.device}")
    return y.reshape(*lead, n)


def _packed_matmul(x, packed, scale, bits, plain, cuda, name) -> torch.Tensor:
    """(..., K) x packed (K·bits/8, N) -> (..., N) f32 through `plain` on a
    CPU tensor or the CUDA kernel `cuda` on a CUDA one."""
    kp, n = packed.shape
    x2, lead = flatten_batch(x)
    _quant_matmul.check_k(x2.shape[1], kp, bits)
    sc = _scale(scale, n, x.device)
    if x.device.type == "cpu":
        y = plain(x2, packed, sc, bits=bits)
    elif x.device.type == "cuda":
        y = cuda(x2.to(torch.float32).contiguous(), packed.contiguous(),
                 sc.contiguous(), bits=bits)
        m, k = x2.shape
        add_kernel_cost(name, 2 * m * k * n,
                        m * k * 4 + packed.numel() + n * 4 + m * n * 4)
    else:
        raise ValueError(f"{name} has no kernel for device {x.device}")
    return y.reshape(*lead, n)


def bitserial_matmul(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    *,
    bits: int,
) -> torch.Tensor:
    """CMUL bit-plane matmul (..., K) x packed (K·bits/8, N) -> (..., N) f32.

    K (the contraction of `x`) must equal packed rows * (8 // bits).
    """
    return _packed_matmul(
        x, packed, scale, bits, _bitserial.bitserial_matmul_plain,
        _bitserial.bitserial_matmul_cuda, _bitserial.NAME,
    )


def quant_matmul(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    *,
    bits: int,
) -> torch.Tensor:
    """Packed dequant matmul (..., K) x packed (K·bits/8, N) -> (..., N) f32.

    K (the contraction of `x`) must equal packed rows * (8 // bits).
    """
    return _packed_matmul(
        x, packed, scale, bits, _quant_matmul.quant_matmul_plain,
        _quant_matmul.quant_matmul_cuda, _quant_matmul.NAME,
    )


def sparse_conv1d(
    x: torch.Tensor,
    values: torch.Tensor,
    select: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    *,
    ksize: int,
    stride: int = 1,
    group_size: int,
    keep: int,
) -> torch.Tensor:
    """Fused sparse-quantized 1-D conv (B, T, C) -> (B, T_out, N) f32, SAME
    padding, T_out = (T - 1) // stride + 1; no bias, no ReLU.

    The compressed weight's dense K, (Kk // keep) * group_size, must cover
    the ksize * C window; rows past it are the compiler's group padding.
    """
    kk, n = values.shape
    _sparse_conv1d.check_geometry(
        tuple(x.shape), kk, ksize=ksize, stride=stride,
        group_size=group_size, keep=keep,
    )
    sc = _scale(scale, n, x.device)
    kw = dict(ksize=ksize, stride=stride, group_size=group_size, keep=keep)
    if x.device.type == "cpu":
        return _sparse_conv1d.sparse_conv1d_plain(x, values, select, sc, **kw)
    if x.device.type == "cuda":
        y = _sparse_conv1d.sparse_conv1d_cuda(
            x.to(torch.float32).contiguous(), values.contiguous(),
            select.contiguous(), sc.contiguous(), **kw,
        )
        # the weights inside the ksize * C window: the kernel skips the
        # groups of the compiler's padding past it
        b, t_out = y.shape[0], y.shape[1]
        live = min(kk, -(-(ksize * x.shape[-1]) // group_size) * keep)
        add_kernel_cost(_sparse_conv1d.NAME, 2 * b * t_out * live * n,
                        x.numel() * 4 + kk * n * 2 + n * 4
                        + b * t_out * n * 4)
        return y
    raise ValueError(f"sparse_conv1d has no kernel for device {x.device}")

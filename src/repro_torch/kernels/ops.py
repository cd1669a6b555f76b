"""Public wrappers of the port's kernels (port of `repro.kernels.ops`).

The matmuls flatten batch dimensions; every wrapper checks its geometry,
defaults the scale, and dispatches by the tensor's device: a CPU tensor takes the kernel's plain PyTorch version, a
CUDA tensor launches the hand-written kernel or raises. There is no
fallback from one to the other.

A fake tensor (`torch._subclasses.fake_tensor`, the dry-run's, on either
device) takes the card's route up to the launch: the same operand
preparation, the output the kernel would write allocated as the CUDA
function allocates it, and the launch's cost reported; nothing is
launched, no kernel library is built or loaded, and the plain version
never runs. So a dry-run counts the card's kernels on any host.

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
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import bitserial as _bitserial
from repro_torch.kernels import nm_spmm as _nm_spmm
from repro_torch.kernels import quant_matmul as _quant_matmul
from repro_torch.kernels import sparse_conv1d as _sparse_conv1d
from repro_torch.kernels._common import flatten_batch
from repro_torch.obs.torchprobe import add_kernel_cost


def _route(x: torch.Tensor, name: str) -> str:
    """"fake" for a fake tensor, else "plain" (CPU) or "cuda"; raises on
    another device."""
    if isinstance(x, FakeTensor):
        return "fake"
    if x.device.type == "cpu":
        return "plain"
    if x.device.type == "cuda":
        return "cuda"
    raise ValueError(f"{name} has no kernel for device {x.device}")


def _out(shape: tuple, x: torch.Tensor) -> torch.Tensor:
    """The float32 output a kernel's CUDA function allocates, for a fake
    `x`: the launch's result without the launch."""
    return torch.empty(shape, dtype=torch.float32, device=x.device)


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
    route = _route(x, "nm_spmm")
    if route == "plain":
        y = _nm_spmm.nm_spmm_plain(
            x2, values, select, sc, group_size=group_size, keep=keep
        )
    else:
        args = (x2.to(torch.float32).contiguous(), values.contiguous(),
                select.contiguous(), sc.contiguous())
        m = x2.shape[0]
        y = (_nm_spmm.nm_spmm_cuda(*args, group_size=group_size, keep=keep)
             if route == "cuda" else _out((m, n), x))
        add_kernel_cost(_nm_spmm.NAME, 2 * m * kk * n,
                        m * k * 4 + kk * n * 2 + n * 4 + m * n * 4)
    return y.reshape(*lead, n)


def _packed_matmul(x, packed, scale, bits, plain, cuda, name) -> torch.Tensor:
    """(..., K) x packed (K·bits/8, N) -> (..., N) f32 through `plain` on a
    CPU tensor or the CUDA kernel `cuda` on a CUDA one."""
    kp, n = packed.shape
    x2, lead = flatten_batch(x)
    _quant_matmul.check_k(x2.shape[1], kp, bits)
    sc = _scale(scale, n, x.device)
    route = _route(x, name)
    if route == "plain":
        y = plain(x2, packed, sc, bits=bits)
    else:
        args = (x2.to(torch.float32).contiguous(), packed.contiguous(),
                sc.contiguous())
        m, k = x2.shape
        if route == "cuda":
            y = cuda(*args, bits=bits)
        else:
            _quant_matmul.check_grid(m, k, n)  # as the CUDA function does
            y = _out((m, n), x)
        add_kernel_cost(name, 2 * m * k * n,
                        m * k * 4 + packed.numel() + n * 4 + m * n * 4)
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
    route = _route(x, "sparse_conv1d")
    if route == "plain":
        return _sparse_conv1d.sparse_conv1d_plain(x, values, select, sc, **kw)
    args = (x.to(torch.float32).contiguous(), values.contiguous(),
            select.contiguous(), sc.contiguous())
    b, t_out = x.shape[0], (x.shape[1] - 1) // stride + 1
    y = (_sparse_conv1d.sparse_conv1d_cuda(*args, **kw) if route == "cuda"
         else _out((b, t_out, n), x))
    # the weights inside the ksize * C window: the kernel skips the
    # groups of the compiler's padding past it
    live = min(kk, -(-(ksize * x.shape[-1]) // group_size) * keep)
    add_kernel_cost(_sparse_conv1d.NAME, 2 * b * t_out * live * n,
                    x.numel() * 4 + kk * n * 2 + n * 4 + b * t_out * n * 4)
    return y

"""sparse_conv1d — one fused VA layer as a CUDA kernel for Hopper, and its
plain twin.

SAME-padded strided windows of a (B, T, C) signal, flattened (tap,
channel), zero-padded to the compiler's group-padded K, through the SPE's
balanced select-index sparse matmul, times the scale — no bias, no ReLU:

    y[b, t, n] = scale[n] * sum_r values[r, n] * patches[b, t, (r // keep) * G + select[r, n]]

`sparse_conv1d_cuda` launches `csrc/sparse_conv1d.cu` on
`csrc/spe_tc.cuh` (replacing the Pallas
`repro/kernels/sparse_conv1d.py:sparse_conv1d_call`; the sources explain
its design and bound), which reads each window from the signal as it
stages it and writes no patches to device memory. `sparse_conv1d_plain`
is the same function in plain PyTorch — `core.spe.im2col`, pad to K,
`nm_spmm_plain` — which the CPU path and the tests use and against which
`chip_smoke.py` holds the kernel on the card.

Like its reference, which holds the whole (Kk, bn) strip and the whole
signal in VMEM, it takes only a strip that fits whole in a block's shared
memory (nm_spmm streams a longer one in segments; every VA layer fits).

`launches` counts kernel launches: `sparse_conv1d_cuda` adds one where it
launches and nowhere else. `launch_geometry` reports the tile width and
grid a launch would take on the current card (no launch).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.spe import im2col, same_padding
from repro_torch.kernels import _build
from repro_torch.kernels.nm_spmm import check_smem, nm_spmm_plain, spe_geometry

NAME = "sparse_conv1d"
launches = 0

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(NAME)
        lib.sparse_conv1d_f32.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int
        ] * 11 + [ctypes.c_void_p]
        lib.sparse_conv1d_f32.restype = ctypes.c_int
        lib.sparse_conv1d_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.sparse_conv1d_smem_bytes.restype = ctypes.c_size_t
        lib.sparse_conv1d_geometry.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)
        ]
        lib.sparse_conv1d_geometry.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_geometry(
    x_shape: tuple[int, ...], kk: int, *, ksize: int, stride: int,
    group_size: int, keep: int,
) -> int:
    """Raise ValueError unless a (B, T, C) signal and Kk compressed rows
    make one layer; return its dense K, (Kk // keep) * group_size."""
    if len(x_shape) != 3:
        raise ValueError(f"x must be (B, T, C), got shape {tuple(x_shape)}")
    if ksize <= 0 or stride <= 0:
        raise ValueError(f"ksize={ksize}, stride={stride} must be positive")
    if keep <= 0 or kk % keep:
        raise ValueError(f"Kk={kk} is not a multiple of keep={keep}")
    k_dense = (kk // keep) * group_size
    if k_dense < ksize * x_shape[2]:
        raise ValueError(
            f"k_dense={k_dense} < ksize*C={ksize * x_shape[2]}: the "
            "compressed weight does not cover the window"
        )
    return k_dense


def launch_geometry(b: int, t_out: int, k_dense: int, n: int) -> dict:
    """The tile width and grid of a `sparse_conv1d_cuda` launch with B * T_out
    output steps, dense K `k_dense` and N columns on the current card
    (`nm_spmm.spe_geometry`)."""
    return spe_geometry(_library().sparse_conv1d_geometry, b * t_out,
                        k_dense, n)


def _check(x, values, select, scale, ksize, stride, group_size, keep) -> None:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"sparse_conv1d_cuda takes CUDA tensors, got x on {dev}")
    for name, t, dtype, ndim in (
        ("x", x, torch.float32, 3),
        ("values", values, torch.int8, 2),
        ("select", select, torch.uint8, 2),
        ("scale", scale, torch.float32, 2),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.ndim != ndim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-D tensor")
    kk, n = values.shape
    if select.shape != (kk, n) or scale.shape != (1, n):
        raise ValueError(
            f"shapes: values {tuple(values.shape)}, select "
            f"{tuple(select.shape)}, scale {tuple(scale.shape)}"
        )
    check_geometry(tuple(x.shape), kk, ksize=ksize, stride=stride,
                   group_size=group_size, keep=keep)
    if x.numel() >= 2**31 or max(kk, n, ksize, stride, group_size) >= 2**31:
        raise ValueError("sizes must fit in a 32-bit int")


def sparse_conv1d_cuda(
    x: torch.Tensor,
    values: torch.Tensor,
    select: torch.Tensor,
    scale: torch.Tensor,
    *,
    ksize: int,
    stride: int,
    group_size: int,
    keep: int,
) -> torch.Tensor:
    """The CUDA kernel on (B, T, C) f32 x, (Kk, N) int8 values, (Kk, N)
    uint8 select and (1, N) f32 scale -> (B, T_out, N) f32, on the current
    stream. Raises on anything the kernel does not take, and if the launch
    fails."""
    global launches
    _check(x, values, select, scale, ksize, stride, group_size, keep)
    b, t, c = x.shape
    kk, n = values.shape
    t_out, pad_l, _ = same_padding(t, ksize, stride)
    y = torch.empty((b, t_out, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    lib = _library()
    k_dense = (kk // keep) * group_size
    check_smem(lib.sparse_conv1d_smem_bytes(k_dense, n),
               f"k_dense={k_dense}, N={n}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sparse_conv1d_f32(
            x.data_ptr(), values.data_ptr(), select.data_ptr(),
            scale.data_ptr(), y.data_ptr(), b, t, c, n, kk, ksize, stride,
            pad_l, t_out, group_size, keep, stream,
        )
    if err != 0:
        raise RuntimeError(f"sparse_conv1d launch failed: CUDA error {err}")
    launches += 1
    return y


def sparse_conv1d_plain(
    x: torch.Tensor,
    values: torch.Tensor,
    select: torch.Tensor,
    scale: torch.Tensor,
    *,
    ksize: int,
    stride: int,
    group_size: int,
    keep: int,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: im2col patches, zero-padded
    to the dense K, then `nm_spmm_plain`. Same arguments as
    `sparse_conv1d_cuda`, any device."""
    patches = im2col(x.to(torch.float32), ksize, stride)
    k_dense = (values.shape[0] // keep) * group_size
    patches = F.pad(patches, (0, k_dense - patches.shape[-1]))
    b, t_out, _ = patches.shape
    y = nm_spmm_plain(
        patches.reshape(b * t_out, k_dense), values, select, scale,
        group_size=group_size, keep=keep,
    )
    return y.reshape(b, t_out, -1)

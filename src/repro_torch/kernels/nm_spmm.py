"""nm_spmm — the SPE array as a CUDA kernel for Hopper, and its plain twin.

Balanced select-index sparse matmul:

    y[m, n] = scale[n] * sum_r values[r, n] * x[m, (r // keep) * G + select[r, n]]

`nm_spmm_cuda` launches `csrc/nm_spmm.cu` on `csrc/spe_tc.cuh`
(replacing the Pallas `repro/kernels/nm_spmm.py:nm_spmm_2d`; the sources
explain its design and bound). `nm_spmm_plain` is the same function in
plain PyTorch — decompress the weight tile, one float32 matmul, scale —
which the CPU path and the tests use and against which `chip_smoke.py`
holds the kernel on the card.

The kernel takes every K the reference's takes: where a block's dense
strip of the weights does not fit in its shared memory (the LMs' widths),
it streams the strip in K segments of whole groups.

`launches` counts kernel launches: `nm_spmm_cuda` adds one where it
launches and nowhere else, so a run can show that its path went through
the kernel. `launch_geometry` reports the tile width, grid and segment a
launch would take on the current card (no launch).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import decompress_tile

NAME = "nm_spmm"
launches = 0
# per-block dynamic shared memory an H100 grants (227 KB)
_MAX_SMEM_BYTES = 232_448

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(NAME)
        lib.nm_spmm_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        lib.nm_spmm_f32.restype = ctypes.c_int
        lib.nm_spmm_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.nm_spmm_smem_bytes.restype = ctypes.c_size_t
        lib.nm_spmm_geometry.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)
        ]
        lib.nm_spmm_geometry.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, values, select, scale, group_size, keep) -> None:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"nm_spmm_cuda takes CUDA tensors, got x on {dev}")
    for name, t, dtype in (
        ("x", x, torch.float32),
        ("values", values, torch.int8),
        ("select", select, torch.uint8),
        ("scale", scale, torch.float32),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    (m, k), (kk, n) = x.shape, values.shape
    if select.shape != (kk, n) or scale.shape != (1, n):
        raise ValueError(
            f"shapes: values {tuple(values.shape)}, select "
            f"{tuple(select.shape)}, scale {tuple(scale.shape)}"
        )
    if keep <= 0 or kk % keep or k != (kk // keep) * group_size:
        raise ValueError(
            f"K={k}, Kk={kk} inconsistent with {keep}:{group_size} sparsity"
        )
    if max(m, k, n, kk) >= 2**31:
        raise ValueError("dimensions must fit in a 32-bit int")


def spe_geometry(fn, *shape: int) -> dict:
    """What the C function `fn` (`<kernel>_geometry` of a library built on
    `csrc/spe_tc.cuh`) says a launch at `shape` ((M, K, N), and the group
    where the kernel takes it) takes on the current card: grid, blocks,
    cluster size, dynamic shared memory in bytes, the blocks an SM holds at
    once, the output tile's width BN and the dense K of a segment of the
    strip (K itself, rounded up to 32, where the whole strip fits)."""
    out = (ctypes.c_int * 8)()
    err = fn(*shape, out)
    if err != 0:
        raise RuntimeError(f"no launch geometry at {shape}: CUDA error {err}")
    grid = tuple(out[:3])
    return {"grid": grid, "blocks": grid[0] * grid[1] * grid[2],
            "cluster": out[3], "smem_bytes": out[4], "blocks_per_sm": out[5],
            "bn": out[6], "seg_k": out[7]}


def launch_geometry(m: int, k: int, n: int, *, group_size: int) -> dict:
    """The tile width, grid and segment of an `nm_spmm_cuda` launch at
    (M, K, N) with `group_size` on the current card (`spe_geometry`)."""
    return spe_geometry(_library().nm_spmm_geometry, m, k, n, group_size)


def check_smem(smem: int, what: str) -> None:
    """Raise ValueError where a launch needs `smem` bytes of shared memory
    a block (a library's `<kernel>_smem_bytes`), over what a block can
    have."""
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"{what} needs {smem} bytes of shared memory per block, over "
            f"the {_MAX_SMEM_BYTES} a block can have"
        )


def nm_spmm_cuda(
    x: torch.Tensor,
    values: torch.Tensor,
    select: torch.Tensor,
    scale: torch.Tensor,
    *,
    group_size: int,
    keep: int,
) -> torch.Tensor:
    """The CUDA kernel on (M, K) f32 x, (Kk, N) int8 values, (Kk, N) uint8
    select and (1, N) f32 scale -> (M, N) f32, on the current stream.
    Raises on anything the kernel does not take, and if the launch fails."""
    global launches
    _check(x, values, select, scale, group_size, keep)
    (m, k), (kk, n) = x.shape, values.shape
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    lib = _library()
    check_smem(lib.nm_spmm_smem_bytes(k, n, group_size),
               f"K={k}, N={n}, group {group_size}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nm_spmm_f32(
            x.data_ptr(), values.data_ptr(), select.data_ptr(),
            scale.data_ptr(), y.data_ptr(), m, k, n, kk, group_size, keep,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"nm_spmm launch failed: CUDA error {err}")
    launches += 1
    return y


def nm_spmm_plain(
    x: torch.Tensor,
    values: torch.Tensor,
    select: torch.Tensor,
    scale: torch.Tensor,
    *,
    group_size: int,
    keep: int,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: decompress, one float32
    matmul (full precision: the default matmul precision is "highest"),
    then the scale. Same arguments as `nm_spmm_cuda`, any device."""
    w = decompress_tile(values, select, group_size, keep)
    return (x.to(torch.float32) @ w) * scale.reshape(1, -1).to(torch.float32)

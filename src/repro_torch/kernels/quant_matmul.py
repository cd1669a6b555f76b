"""quant_matmul — the packed sub-byte dequant matmul as a CUDA kernel for
Hopper, and its plain twin.

    y[m, n] = scale[n] * sum_k x[m, k] * unpack(packed)[k, n]

with `packed` the (K·bits/8, N) uint8 words of `core.quant.pack_planes`
(8/bits two's-complement fields a byte, least significant first along K;
1-bit fields are {0,1} -> {-1,+1}), bits in {8, 4, 2, 1}.

`quant_matmul_cuda` launches `csrc/quant_matmul.cu` (replacing the Pallas
`repro/kernels/quant_matmul.py:quant_matmul_2d`; the source explains its
design and bound). `quant_matmul_plain` is the same function in plain
PyTorch — `unpack_tile`, float32, one matmul, scale — which the CPU path
and the tests use and against which `chip_smoke.py` holds the kernel on
the card.

`launches` counts kernel launches: `quant_matmul_cuda` adds one where it
launches and nowhere else. `launch_geometry` reports the grid and the
cluster split a launch would take on the current card (no launch).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import unpack_tile

NAME = "quant_matmul"
BITS = (8, 4, 2, 1)
launches = 0

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(NAME)
        lib.quant_matmul_f32.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int
        ] * 4 + [ctypes.c_void_p]
        lib.quant_matmul_f32.restype = ctypes.c_int
        lib.quant_matmul_geometry.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)
        ]
        lib.quant_matmul_geometry.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_k(k: int, packed_rows: int, bits: int) -> None:
    """Raise ValueError unless `bits` is supported and x's K equals
    packed_rows * (8 // bits)."""
    if bits not in BITS:
        raise ValueError(f"bits must be one of {BITS}, got {bits}")
    if k != packed_rows * (8 // bits):
        raise ValueError(
            f"K={k} != packed rows {packed_rows} x {8 // bits} values per "
            f"byte at {bits} bits"
        )


def check_operands(x, packed, scale, bits, fn: str) -> None:
    """Raise unless (x, packed, scale) are what the packed-weight kernels
    take: contiguous 2-D CUDA tensors of one device, float32 x and scale,
    uint8 packed, consistent shapes, within a 64-row-tile grid. `fn` names
    the caller in the message."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors, got x on {dev}")
    for name, t, dtype in (
        ("x", x, torch.float32),
        ("packed", packed, torch.uint8),
        ("scale", scale, torch.float32),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    (m, k), (kp, n) = x.shape, packed.shape
    if scale.shape != (1, n):
        raise ValueError(
            f"shapes: packed {tuple(packed.shape)}, scale {tuple(scale.shape)}"
        )
    check_k(k, kp, bits)
    check_grid(m, k, n)


def check_grid(m: int, k: int, n: int) -> None:
    """Raise ValueError where an (M, K) x (K, N) launch is out of the
    packed-weight kernels' grid (64-row tiles, 32-bit indices)."""
    if max(m, k, n) >= 2**31 or m > 65535 * 64:
        raise ValueError(f"M={m}, K={k}, N={n} out of the kernel's grid")


def cmul_geometry(fn, m: int, k: int, n: int, bits: int) -> dict:
    """What the C function `fn` (`<kernel>_geometry` of a library built on
    `csrc/cmul_tc.cuh`) says a launch at (M, K, N) takes on the current
    card: grid, blocks, cluster size (the K split), dynamic shared memory
    in bytes and the blocks an SM holds at once."""
    out = (ctypes.c_int * 6)()
    err = fn(m, k, n, bits, out)
    if err != 0:
        raise RuntimeError(f"no launch geometry at bits={bits}: CUDA error {err}")
    grid = tuple(out[:3])
    return {"grid": grid, "blocks": grid[0] * grid[1] * grid[2],
            "cluster": out[3], "smem_bytes": out[4], "blocks_per_sm": out[5]}


def launch_geometry(m: int, k: int, n: int, *, bits: int) -> dict:
    """The grid and cluster split of a `quant_matmul_cuda` launch at
    (M, K, N) on the current card (`cmul_geometry`)."""
    return cmul_geometry(_library().quant_matmul_geometry, m, k, n, bits)


def quant_matmul_cuda(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    *,
    bits: int,
) -> torch.Tensor:
    """The CUDA kernel on (M, K) f32 x, (K·bits/8, N) uint8 packed and
    (1, N) f32 scale -> (M, N) f32, on the current stream. Raises on
    anything the kernel does not take, and if the launch fails."""
    global launches
    check_operands(x, packed, scale, bits, "quant_matmul_cuda")
    (m, k), n = x.shape, packed.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quant_matmul_f32(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
            m, k, n, bits, stream,
        )
    if err != 0:
        raise RuntimeError(f"quant_matmul launch failed: CUDA error {err}")
    launches += 1
    return y


def quant_matmul_plain(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    *,
    bits: int,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: unpack, float32, one matmul
    (full precision: the default matmul precision is "highest"), then the
    scale. Same arguments as `quant_matmul_cuda`, any device."""
    w = unpack_tile(packed, bits).to(torch.float32)
    return (x.to(torch.float32) @ w) * scale.reshape(1, -1).to(torch.float32)

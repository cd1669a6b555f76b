"""bitserial_matmul — the CMUL as a CUDA kernel for Hopper, and its plain
twin.

The chip's configurable multiplier splits each B-bit weight into 1-bit
segments, multiplies each against the activation and shift-accumulates:

    y = scale * sum_b s_b 2^b (x @ W_b),   s_b = -1 for the sign plane else +1

with W_b the {0,1} two's-complement bit planes of the weight unpacked from
`packed`, the (K·bits/8, N) uint8 words of `core.quant.pack_planes`; at
1 bit the single plane encodes {-1,+1}, so y = scale * (2·(x @ W_0) −
rowsum(x)). The result equals the dequantized matmul of `quant_matmul`;
the plane decomposition is the CMUL's own arithmetic.

`bitserial_matmul_cuda` launches `csrc/bitserial_matmul.cu` (replacing
the Pallas `repro/kernels/bitserial.py:bitserial_matmul_2d`; the source
explains its design and bound). `bitserial_matmul_plain` is the same
function in plain PyTorch — unpack, bit planes, one float32 matmul per
plane, shift-accumulate, scale — which the CPU path and the tests use and
against which `chip_smoke.py` holds the kernel on the card.

`launches` counts kernel launches: `bitserial_matmul_cuda` adds one where
it launches and nowhere else. `launch_geometry` reports the grid and the
cluster split a launch would take on the current card (no launch).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import quant as Q
from repro_torch.kernels import _build
from repro_torch.kernels._common import unpack_tile
from repro_torch.kernels.quant_matmul import check_operands, cmul_geometry

NAME = "bitserial_matmul"
BITS = (8, 4, 2, 1)
launches = 0

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(NAME)
        lib.bitserial_matmul_f32.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int
        ] * 4 + [ctypes.c_void_p]
        lib.bitserial_matmul_f32.restype = ctypes.c_int
        lib.bitserial_matmul_geometry.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)
        ]
        lib.bitserial_matmul_geometry.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch_geometry(m: int, k: int, n: int, *, bits: int) -> dict:
    """The grid and cluster split of a `bitserial_matmul_cuda` launch at
    (M, K, N) on the current card (`quant_matmul.cmul_geometry`)."""
    return cmul_geometry(_library().bitserial_matmul_geometry, m, k, n, bits)


def bitserial_matmul_cuda(
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
    check_operands(x, packed, scale, bits, "bitserial_matmul_cuda")
    (m, k), n = x.shape, packed.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bitserial_matmul_f32(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
            m, k, n, bits, stream,
        )
    if err != 0:
        raise RuntimeError(f"bitserial_matmul launch failed: CUDA error {err}")
    launches += 1
    return y


def bitserial_matmul_plain(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    *,
    bits: int,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: unpack the fields, take
    their bit planes, one float32 matmul per plane (full precision), the
    shift-accumulate of `core.quant.bitserial_matmul_exact`, then the
    scale. Same arguments as `bitserial_matmul_cuda`, any device."""
    q = unpack_tile(packed, bits)
    y = Q.bitserial_matmul_exact(x.to(torch.float32), q, bits)
    return y * scale.reshape(1, -1).to(torch.float32)

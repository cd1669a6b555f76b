"""Kernel micro-benchmarks of the port (port of `benchmarks/kernels.py`).

    python -m repro_torch.benchmarks.kernels

Times `ops.nm_spmm`, `ops.quant_matmul` at 8, 4, 2 and 1 bits and
`ops.sparse_conv1d` on a VA layer-0 signal, at the reference script's
shapes: one warm call, then the mean of 3 calls, synchronised on a CUDA
device. The derived column is the structural quantity the reference
reports: bytes of weight storage a matmul reads against dense float32.
Every row's output is held against `kernels.ref` at 1e-4.

The inputs come from a seeded `torch.Generator`. The reference draws
from `jax.random`, which torch cannot reproduce, so the rows match the
reference's by shape, not by value.

`device=None` means the CUDA card, where each call launches the
hand-written kernel; without a card it raises. On the CPU the wrappers
run the kernels' plain versions.
"""

from __future__ import annotations

import time

import torch

from repro_torch._device import DeviceLike, resolve
from repro_torch.core import quant as Q
from repro_torch.core import sparsity as S
from repro_torch.kernels import ops, ref

M, K, N = 128, 512, 256
G, KEEP = 16, 8
SEED = 0
TOL = 1e-4  # float32, summed in another order (benchmarks/kernels.py)
REPS = 3


def _time(dev: torch.device, fn, *args):
    """(microseconds per call, last output): one warm call, then REPS."""
    fn(*args)  # warm: the first call on the card builds the kernel
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / REPS * 1e6, out


def _check(y: torch.Tensor, y_ref: torch.Tensor) -> None:
    torch.testing.assert_close(y, y_ref, rtol=TOL, atol=TOL)


def run(device: DeviceLike = None) -> list[tuple[str, float, str]]:
    """The benchmark's rows, (name, us_per_call, derived), in the
    reference's order: nm_spmm, quant_matmul_{8,4,2,1}b, sparse_conv1d."""
    dev = resolve(device)
    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape: int) -> torch.Tensor:
        return torch.randn(shape, generator=gen).to(dev)

    rows = []
    x = randn(M, K)
    w = randn(K, N)
    dense_bytes = K * N * 4
    scfg = S.SparsityConfig(G, KEEP)

    # nm_spmm (SPE): int8 values + uint8 selects, half the rows
    values, select = S.compress(S.apply_prune(w, scfg), scfg)
    q, scale = Q.quantize(values, Q.QuantConfig(bits=8))
    scale = scale.reshape(1, -1)
    us, y = _time(dev, lambda a: ops.nm_spmm(a, q, select, scale,
                                             group_size=G, keep=KEEP), x)
    _check(y, ref.nm_spmm_ref(x, q, select, scale, group_size=G, keep=KEEP))
    spe_bytes = q.numel() + select.numel() // 2 + N * 4
    rows.append(("kernels.nm_spmm", us,
                 f"hbm_bytes={spe_bytes} vs_dense_f32={dense_bytes} "
                 f"({dense_bytes / spe_bytes:.2f}x)"))

    # quant_matmul at each CMUL precision
    for bits in (8, 4, 2, 1):
        qd, sd = Q.quantize(w, Q.QuantConfig(bits=bits))
        packed = Q.pack_planes(qd, bits)
        sd = sd.reshape(1, -1)
        us, y = _time(
            dev, lambda a, p=packed, s=sd, b=bits: ops.quant_matmul(
                a, p, s, bits=b), x,
        )
        _check(y, ref.quant_matmul_ref(x, packed, sd, bits=bits, k=K))
        b = packed.numel() + N * 4
        rows.append((f"kernels.quant_matmul_{bits}b", us,
                     f"hbm_bytes={b} ({dense_bytes / b:.2f}x)"))

    # fused sparse conv (one VA layer)
    ks, stride, c, nout, t = 7, 2, 4, 16, 512
    kd = -(-(ks * c) // G) * G
    wc = randn(kd, nout)
    v2, s2 = S.compress(S.apply_prune(wc, scfg), scfg)
    q2, sc2 = Q.quantize(v2, Q.QuantConfig(bits=8))
    sc2 = sc2.reshape(1, -1)
    sig = randn(4, t, c)
    us, y = _time(
        dev, lambda a: ops.sparse_conv1d(a, q2, s2, sc2, ksize=ks,
                                         stride=stride, group_size=G,
                                         keep=KEEP), sig,
    )
    _check(y, ref.sparse_conv1d_ref(sig, q2, s2, sc2, ksize=ks, stride=stride,
                                    group_size=G, keep=KEEP))
    rows.append(("kernels.sparse_conv1d", us,
                 "fused_im2col=True (no HBM patch materialization)"))
    return rows


def main() -> None:
    for name, us, derived in run():
        print(f"{name},{us:.2f},{derived}")


if __name__ == "__main__":
    main()

"""The SPE kernels' arithmetic (`csrc/spe_tc.cuh`: `nm_spmm` and
`sparse_conv1d` on the tensor cores) emulated on the CPU, against the JAX
package's `nm_spmm_2d`.

The CUDA kernels run only on a card (tests/test_torch_cuda.py). What they
compute is emulated here: the compressed strip decoded to a dense B
(exact: int8 codes), x split into x_hi = rna_tf32(x) and x_lo =
rna_tf32(x - x_hi), both multiplied by B a 32-wide K chunk at a time into
one float32 chunk sum, the chunk sums added in float32, the scale last.
Held against the JAX wrapper (its Pallas kernel in interpret mode) at the
kernels' tolerance, 1e-4 of max|y| (tests/test_kernels.py's float32
tolerance), at the seven sparse VA layers' (K, Kk, N) and small M. One
pass (x_hi alone) misses that tolerance at every one of the seven.

The window addressing of `sparse_conv1d.cu` (each output step's row read
from the signal, zero outside it and past ks * C) is mirrored here and
held to im2col -> pad, the matrix `nm_spmm` takes on execute's path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _torch_bridge import n, t

from repro.core import quant as JQ
from repro.core import sparsity as JS
from repro.kernels import ops as jops
from repro_torch.core import spe as tspe
from repro_torch.kernels import _build
from repro_torch.kernels._common import decompress_tile

G, KEEP = 16, 8
CFG = JS.SparsityConfig(G, KEEP)
TOL = 1e-4
CHUNK = 32  # spe_tc.cuh's K chunk
# (K, N) of the seven sparse VA layers (Kk = K / 2): conv0 .. conv6
VA_LAYERS = [(32, 16), (80, 24), (128, 32), (96, 48), (144, 64), (192, 64),
             (192, 96)]


def _rna_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 explicit mantissa bits, to nearest with
    ties away from zero (cvt.rna.tf32.f32), by integer ops on the bits."""
    return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _spe_emulation(x, values, select, scale, passes=2):
    """The SPE kernels' arithmetic on the CPU (see the module docstring)."""
    w = decompress_tile(values, select, G, KEEP)
    tot = torch.zeros((x.shape[0], w.shape[1]))
    for k0 in range(0, x.shape[1], CHUNK):
        xc = x[:, k0:k0 + CHUNK]
        x_hi = _rna_tf32(xc)
        acc = torch.zeros_like(tot)
        for a in (x_hi, _rna_tf32(xc - x_hi))[:passes]:
            acc = acc + a @ w[k0:k0 + CHUNK]
        tot = tot + acc
    return tot * scale


def _jax_case(m, k, nn):
    """(x, int8 values, uint8 select, (1, N) scale) as numpy, compiled by
    the JAX package, and its nm_spmm's y."""
    w = np.random.default_rng(k * 7 + nn).standard_normal((k, nn))
    values, select = JS.compress(
        JS.apply_prune(jnp.asarray(w, jnp.float32), CFG), CFG)
    q, scale = JQ.quantize(values, JQ.QuantConfig(bits=8))
    q, sel, sc = n(q), n(select), n(scale).reshape(1, -1)
    x = np.random.default_rng(m + k).standard_normal((m, k)).astype(np.float32)
    y = n(jops.nm_spmm(jnp.asarray(x), jnp.asarray(q), jnp.asarray(sel),
                       jnp.asarray(sc), group_size=G, keep=KEEP))
    return x, q, sel, sc, y


def _rel(y, y_ref) -> float:
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


@pytest.mark.parametrize("m", [64, 130])
@pytest.mark.parametrize("k,nn", VA_LAYERS)
def test_two_tf32_passes_meet_the_float32_tolerance_at_the_va_layers(m, k, nn):
    x, q, sel, sc, y_jax = _jax_case(m, k, nn)
    y = _spe_emulation(t(x), t(q), t(sel), t(sc))
    assert _rel(n(y), y_jax) <= TOL


@pytest.mark.parametrize("k,nn", VA_LAYERS)
def test_one_tf32_pass_misses_the_float32_tolerance_at_the_va_layers(k, nn):
    """Why the SPE kernels take two passes: x_hi alone is 1.5e-4 to 2.9e-4
    of max|y| off the reference at these layers, every one outside 1e-4."""
    x, q, sel, sc, y_jax = _jax_case(64, k, nn)
    y = _spe_emulation(t(x), t(q), t(sel), t(sc), passes=1)
    assert _rel(n(y), y_jax) > TOL


def _window_rows(m, *, T, C, t_out, stride, pad_l, kc):
    """sparse_conv1d.cu's WindowRows::row: (base, lo, hi) of output step
    m = b * T_out + t in the flattened (B * T * C) signal."""
    b, tt = divmod(m, t_out)
    s = (tt * stride - pad_l) * C
    return b * T * C + s, max(0, -s), min(kc, T * C - s)


# (B, T, C, ksize, stride): conv0, conv2, conv6 of the VA model at batch 4,
# then ragged ones: T < ksize, even ksize, stride 3, C off a multiple of 4
CONV_GEOMETRIES = [(4, 512, 4, 7, 2), (4, 128, 24, 5, 1), (4, 32, 64, 3, 2),
                   (3, 5, 8, 7, 1), (2, 20, 6, 4, 3), (3, 65, 5, 3, 2)]


@pytest.mark.parametrize("b,tt,c,ks,stride", CONV_GEOMETRIES)
def test_window_addressing_reproduces_im2col(b, tt, c, ks, stride):
    """Row m of the patch matrix, as sparse_conv1d.cu's copies read it
    (x[base + k] for lo <= k < hi, else 0), equals im2col -> pad to the
    group-padded K."""
    k_dense = -(-(ks * c) // G) * G
    x = torch.randn((b, tt, c), generator=torch.Generator().manual_seed(tt))
    t_out, pad_l, _ = tspe.same_padding(tt, ks, stride)
    want = F.pad(tspe.im2col(x, ks, stride), (0, k_dense - ks * c))
    flat = x.reshape(-1)
    got = torch.zeros((b * t_out, k_dense))
    for m in range(b * t_out):
        base, lo, hi = _window_rows(m, T=tt, C=c, t_out=t_out, stride=stride,
                                    pad_l=pad_l, kc=ks * c)
        if lo < hi:
            got[m, lo:hi] = flat[base + lo:base + hi]
    assert torch.equal(got, want.reshape(b * t_out, k_dense))


@pytest.mark.parametrize("name", ["nm_spmm", "sparse_conv1d"])
def test_spe_sources_share_one_header(name):
    """Both SPE kernels are built on spe_tc.cuh, which takes cmul_tc.cuh's
    building blocks; the build target covers both headers."""
    assert [p.name for p in _build.sources(name)] == [
        f"{name}.cu", "spe_tc.cuh", "cmul_tc.cuh"]

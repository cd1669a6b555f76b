"""PyTorch port vs JAX package: the CMUL — `core.quant`'s bit-plane math
and `kernels.ops.bitserial_matmul`.

Same numpy inputs through `repro` and `repro_torch`. Bit planes and
recomposed integers must be bit-identical. Float results are held at the
JAX suite's own tolerances: `bitserial_matmul_exact` and
`quantized_matmul` against the reference's at rtol 1e-5, atol 1e-4
(tests/test_quant.py); the kernel wrapper against
the JAX wrapper (its Pallas kernel in interpret mode) and the oracle at
1e-4, and against `x @ dequantize(q, scale)` at 1e-3
(tests/test_kernels.py): the two packages sum in different orders. The
CUDA kernel itself runs only on a card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import n, t

from repro.core import quant as JQ
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import quant as TQ
from repro_torch.kernels import _build
from repro_torch.kernels import bitserial as tbs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

BITS = [8, 4, 2, 1]
SWEEP = [(8, 64, 16), (33, 128, 40)]  # tests/test_kernels.py's CMUL sweep
TOL = 1e-4


def _codes(k: int, nn: int, bits: int, seed: int):
    """(int8 codes, (N,) f32 scale) of a random weight, as numpy, from the
    JAX quantizer (the port's is bit-identical, tests/test_torch_core.py)."""
    w = np.random.default_rng(seed).standard_normal((k, nn)).astype(np.float32)
    q, scale = JQ.quantize(jnp.asarray(w), JQ.QuantConfig(bits=bits))
    return n(q), n(scale).reshape(-1)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("bits", BITS)
def test_bitplanes_identical(bits):
    q, _ = _codes(48, 16, bits, 1)
    pj = JQ.to_bitplanes(jnp.asarray(q), bits)
    pt = TQ.to_bitplanes(t(q), bits)
    assert pt.dtype == torch.uint8
    assert tuple(pt.shape) == (bits, 48, 16)
    np.testing.assert_array_equal(n(pt), n(pj))
    back_j = JQ.from_bitplanes(pj, bits)
    back_t = TQ.from_bitplanes(pt, bits)
    assert back_t.dtype == torch.int32
    np.testing.assert_array_equal(n(back_t), n(back_j))
    np.testing.assert_array_equal(n(back_t), q.astype(np.int32))


@pytest.mark.parametrize("bits", BITS)
def test_bitserial_exact_and_quantized_matmul(bits):
    q, scale = _codes(64, 24, bits, 3)
    x = _x((8, 64), 4)
    y_t = TQ.bitserial_matmul_exact(t(x), t(q), bits)
    y_j = JQ.bitserial_matmul_exact(jnp.asarray(x), jnp.asarray(q), bits)
    np.testing.assert_allclose(n(y_t), n(y_j), rtol=1e-5, atol=1e-4)
    # against the exact product: at 8 bits the sign plane's partial sum is
    # weighted by 128 and its float32 rounding reaches a few 1e-4 at K = 64
    # — the reference's own result misses atol 1e-4 on these inputs by as
    # much — so the identity is held at atol 1e-3
    y_exact = x.astype(np.float64) @ q.astype(np.float64)
    np.testing.assert_allclose(n(y_t), y_exact, rtol=1e-5, atol=1e-3)
    for exact in (False, True):
        got = TQ.quantized_matmul(t(x), t(q), t(scale), bits,
                                  exact_bitserial=exact)
        want = JQ.quantized_matmul(jnp.asarray(x), jnp.asarray(q),
                                   jnp.asarray(scale), bits,
                                   exact_bitserial=exact)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape,bits", [((64, 24), 8), ((33, 20), 4),
                                        ((7,), 1), ((), 2)])
def test_storage_bits(shape, bits):
    assert TQ.storage_bits(shape, bits) == JQ.storage_bits(shape, bits)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("m,k,nn", SWEEP)
def test_bitserial_matmul_matches_jax(bits, m, k, nn):
    q, scale = _codes(k, nn, bits, bits)
    packed = n(JQ.pack_planes(jnp.asarray(q), bits))
    sc = scale.reshape(1, -1)
    x = _x((m, k), 9)
    xj, pj, sj = jnp.asarray(x), jnp.asarray(packed), jnp.asarray(sc)
    want = {
        "ops": jops.bitserial_matmul(xj, pj, sj, bits=bits),
        "bitserial_matmul_ref": jref.bitserial_matmul_ref(xj, pj, sj,
                                                          bits=bits, k=k),
    }
    y = tops.bitserial_matmul(t(x), t(packed), t(sc), bits=bits)
    y_ref = tref.bitserial_matmul_ref(t(x), t(packed), t(sc), bits=bits, k=k)
    assert y.dtype == torch.float32 and tuple(y.shape) == (m, nn)
    for got in (y, y_ref):
        for name, y_jax in want.items():
            np.testing.assert_allclose(n(got), n(y_jax), rtol=TOL, atol=TOL,
                                       err_msg=name)
    y_q = tops.quant_matmul(t(x), t(packed), t(sc), bits=bits)
    np.testing.assert_allclose(n(y), n(y_q), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(n(y), x @ (q.astype(np.float32) * sc),
                               rtol=1e-3, atol=1e-3)


def test_bitserial_matmul_batched_input_and_default_scale():
    q, _ = _codes(64, 12, 4, 0)
    packed = TQ.pack_planes(t(q), 4)
    x = _x((3, 5, 64), 2)
    y = tops.bitserial_matmul(t(x), packed, bits=4)
    assert tuple(y.shape) == (3, 5, 12)
    np.testing.assert_allclose(n(y), x @ q.astype(np.float32),
                               rtol=TOL, atol=TOL)


def test_bitserial_matmul_rejects_k_mismatch():
    q, _ = _codes(64, 12, 4, 0)
    packed = TQ.pack_planes(t(q), 4)  # 32 packed rows hold K = 64
    with pytest.raises(ValueError, match="K=48"):
        tops.bitserial_matmul(torch.zeros((4, 48)), packed, bits=4)


def test_bitserial_matmul_has_no_fallback_for_other_devices():
    q, _ = _codes(64, 12, 4, 0)
    packed = TQ.pack_planes(t(q), 4)
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.bitserial_matmul(torch.empty((4, 64), device="meta"), packed,
                              bits=4)


def test_bitserial_cuda_wrapper_checks_before_building():
    """CPU tensors are refused before any build or launch."""
    q, _ = _codes(64, 12, 4, 0)
    packed = TQ.pack_planes(t(q), 4)
    before = tbs.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbs.bitserial_matmul_cuda(torch.zeros((4, 64)), packed,
                                  torch.ones((1, 12)), bits=4)
    assert tbs.launches == before
    assert tbs.NAME not in _build._LOADED

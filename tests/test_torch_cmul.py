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
CUDA kernel itself runs only on a card (tests/test_torch_cuda.py); its
arithmetic (two TF32 passes on the tensor cores) is emulated here and held
against the reference at the kernel's tolerance, 1e-4.
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


# -- the CUDA kernels' arithmetic: two TF32 passes (csrc/cmul_tc.cuh) --------

BENCH = (128, 512, 256)  # (M, K, N) of the kernel benchmark


def _rna_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 explicit mantissa bits, to nearest with
    ties away from zero (cvt.rna.tf32.f32), by integer ops on the bits."""
    return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _operands(packed: torch.Tensor, bits: int, form: str) -> list:
    """The exact float32 B operands the kernel unpacks: quant_matmul's one
    dequantized code, or bitserial_matmul's c_b * P_b per plane (c_b = 2^b,
    the sign plane -2^(bits-1); 1 bit: 2 * P_0)."""
    vpb, mask = 8 // bits, (1 << bits) - 1
    shifts = torch.arange(vpb, dtype=torch.int32).reshape(1, vpb, 1) * bits
    u = (packed.to(torch.int32)[:, None, :] >> shifts) & mask
    u = u.reshape(-1, packed.shape[1])
    if form == "quant":
        if bits == 1:
            return [torch.where(u > 0, 1.0, -1.0)]
        return [torch.where(u >= 1 << (bits - 1), u - (1 << bits), u).float()]
    coeff = [2.0] if bits == 1 else [2.0**b for b in range(bits - 1)] + [
        -(2.0 ** (bits - 1))]
    return [((u >> b) & 1).float() * c for b, c in enumerate(coeff)]


def _tf32_kernel_emulation(x, packed, scale, bits, form, passes=2):
    """The kernel's arithmetic on the CPU: x split into x_hi = rna(x) and
    x_lo = rna(x - x_hi), each multiplied by every exact B operand and
    summed in float32; at 1 bit the plane form subtracts rowsum(x)."""
    x_hi = _rna_tf32(x)
    parts = (x_hi, _rna_tf32(x - x_hi))[:passes]
    y = torch.zeros((x.shape[0], packed.shape[1]))
    for b_op in _operands(packed, bits, form):
        for a in parts:
            y = y + a @ b_op
    if form == "bitserial" and bits == 1:
        y = y - x.sum(dim=1, keepdim=True)
    return y * scale


def _jax_case(bits, m, k, nn):
    """(x, packed, scale) as numpy and the JAX reference's y."""
    q, scale = _codes(k, nn, bits, bits)
    packed = n(JQ.pack_planes(jnp.asarray(q), bits))
    sc = scale.reshape(1, -1)
    x = _x((m, k), 9)
    y_ref = n(jref.bitserial_matmul_ref(jnp.asarray(x), jnp.asarray(packed),
                                        jnp.asarray(sc), bits=bits, k=k))
    return x, packed, sc, y_ref


def _rel(y, y_ref) -> float:
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    v = torch.tensor([one + 2.0**-12, one + 2.0**-11, one + 3 * 2.0**-11,
                      -(one + 2.0**-11), 3.0, 1e-20, -1e20])
    want = [one, one + 2.0**-10, one + 2 * 2.0**-10, -(one + 2.0**-10), 3.0]
    assert _rna_tf32(v)[:5].tolist() == want
    assert bool(((_rna_tf32(v[5:]) - v[5:]).abs() <= 2.0**-11 * v[5:].abs()).all())


@pytest.mark.parametrize("form", ["quant", "bitserial"])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("m,k,nn", SWEEP + [BENCH])
def test_two_tf32_passes_meet_the_float32_tolerance(form, bits, m, k, nn):
    """x_hi . Q + x_lo . Q (quant_matmul) and sum_b x_h . (c_b P_b)
    (bitserial_matmul) against ref.bitserial_matmul_ref at 1e-4: the
    weight operand is exact in TF32, and only x is split."""
    x, packed, sc, y_ref = _jax_case(bits, m, k, nn)
    y = _tf32_kernel_emulation(t(x), t(packed), t(sc), bits, form)
    assert _rel(n(y), y_ref) <= TOL


@pytest.mark.parametrize("form", ["quant", "bitserial"])
@pytest.mark.parametrize("bits", BITS)
def test_one_tf32_pass_misses_the_float32_tolerance(form, bits):
    """Why the kernels take two passes: x_hi alone at the benchmark shape
    is about 2e-4 of max|y| off the reference, outside 1e-4."""
    x, packed, sc, y_ref = _jax_case(bits, *BENCH)
    y = _tf32_kernel_emulation(t(x), t(packed), t(sc), bits, form, passes=1)
    assert _rel(n(y), y_ref) > TOL


def test_build_target_covers_included_headers(tmp_path, monkeypatch):
    """A kernel's build target names a digest of its source and every
    header it includes, so that an edited header is built anew; computing
    it runs no compiler."""
    def no_compiler(*args, **kwargs):
        raise AssertionError("the target name ran a compiler")

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "nvcc", no_compiler)
    monkeypatch.setattr(_build.subprocess, "Popen", no_compiler)
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// one\n")
    assert _build.sources("k") == [tmp_path / f for f in ("k.cu", "h.cuh", "g.cuh")]
    first = _build._target("k")
    assert first.name.startswith("k-") and first.suffix == ".so"
    assert _build._target("k") == first
    (tmp_path / "g.cuh").write_text("// two\n")
    second = _build._target("k")
    assert second != first
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n// edit\n')
    assert _build._target("k") not in (first, second)


@pytest.mark.parametrize("name", ["quant_matmul", "bitserial_matmul"])
def test_cmul_sources_share_one_header(name):
    assert [p.name for p in _build.sources(name)] == [f"{name}.cu", "cmul_tc.cuh"]

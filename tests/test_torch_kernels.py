"""PyTorch port's kernel wrappers (`nm_spmm`, `quant_matmul`,
`sparse_conv1d`) and oracles vs the JAX package's, the ported kernel
benchmark, and the wrappers' boundaries.

On a CPU host the port's `ops.*` dispatch to the plain versions and the
JAX ones run their Pallas kernels in interpret mode, as the JAX suite
does. Both are held to 1e-4 — the float32 tolerance of
tests/test_kernels.py: the two sum in different orders. The CUDA kernels
themselves run only on a card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import n, t
from hypothesis import given, settings, strategies as st

from repro.core import quant as JQ
from repro.core import sparsity as JS
from repro.kernels import _common as jcommon
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import spe as tspe
from repro_torch.kernels import _common as tcommon
from repro_torch.kernels import nm_spmm as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

G, KEEP = 16, 8
CFG = JS.SparsityConfig(G, KEEP)
TOL = 1e-4


def _compressed(k: int, nn: int, seed: int):
    """int8 values, uint8 select, (1, N) f32 scale — numpy, via the JAX
    compiler path."""
    w = np.random.default_rng(seed).standard_normal((k, nn)).astype(np.float32)
    values, select = JS.compress(JS.apply_prune(jnp.asarray(w), CFG), CFG)
    q, scale = JQ.quantize(values, JQ.QuantConfig(bits=8))
    return n(q), n(select), n(scale).reshape(1, -1)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("m,k,nn", [(4, 32, 8), (16, 64, 24), (130, 256, 130),
                                    (1, 16, 1)])
def test_nm_spmm_matches_jax(m, k, nn):
    q, sel, sc = _compressed(k, nn, m * 7 + nn)
    x = _x((m, k), 1)
    y_jax = jops.nm_spmm(jnp.asarray(x), jnp.asarray(q), jnp.asarray(sel),
                         jnp.asarray(sc), group_size=G, keep=KEEP)
    y_jref = jref.nm_spmm_ref(jnp.asarray(x), jnp.asarray(q), jnp.asarray(sel),
                              jnp.asarray(sc), group_size=G, keep=KEEP)
    y = tops.nm_spmm(t(x), t(q), t(sel), t(sc), group_size=G, keep=KEEP)
    y_ref = tref.nm_spmm_ref(t(x), t(q), t(sel), t(sc), group_size=G, keep=KEEP)
    assert y.dtype == torch.float32 and tuple(y.shape) == (m, nn)
    for got in (y, y_ref):
        np.testing.assert_allclose(n(got), n(y_jax), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(n(got), n(y_jref), rtol=TOL, atol=TOL)


def test_nm_spmm_batched_input_and_default_scale():
    q, sel, _ = _compressed(64, 12, 0)
    x = _x((3, 5, 64), 2)
    y = tops.nm_spmm(t(x), t(q), t(sel), group_size=G, keep=KEEP)
    assert tuple(y.shape) == (3, 5, 12)
    y_ref = tref.nm_spmm_ref(t(x), t(q), t(sel), None, group_size=G, keep=KEEP)
    np.testing.assert_allclose(n(y), n(y_ref), rtol=TOL, atol=TOL)


def test_decompress_tile_identical():
    q, sel, _ = _compressed(96, 20, 3)
    dj = jcommon.decompress_tile(jnp.asarray(q), jnp.asarray(sel), G, KEEP)
    dt = tcommon.decompress_tile(t(q), t(sel), G, KEEP)
    np.testing.assert_array_equal(n(dt), n(dj))


@settings(max_examples=20, deadline=None)
@given(
    m=st.integers(1, 40),
    groups=st.integers(1, 4),
    nn=st.integers(1, 20),
    seed=st.integers(0, 2**31 - 1),
)
def test_nm_spmm_property(m, groups, nn, seed):
    """Against a float64 numpy oracle built straight from the definition
    (weights compiled by the port, so no jax compile per shape)."""
    k = groups * G
    rng = np.random.default_rng(seed)
    layer = tspe.compile_layer(
        t(rng.standard_normal((k, nn)), np.float32), tspe.SPEConfig()
    )
    q, sel, sc = n(layer.values_q), n(layer.select), n(layer.scale)
    x = rng.standard_normal((m, k)).astype(np.float32)
    rows = (np.arange(q.shape[0]) // KEEP)[:, None] * G + sel.astype(np.int64)
    w = np.zeros((k, nn))
    np.put_along_axis(w, rows, q.astype(np.float64), axis=0)
    want = x.astype(np.float64) @ w * sc
    y = tops.nm_spmm(t(x), layer.values_q, layer.select, layer.scale,
                     group_size=G, keep=KEEP)
    np.testing.assert_allclose(n(y), want, rtol=TOL, atol=TOL)


def test_nm_spmm_rejects_inconsistent_k():
    q, sel, sc = _compressed(32, 8, 0)
    with pytest.raises(ValueError, match="inconsistent"):
        tops.nm_spmm(t(_x((4, 48), 0)), t(q), t(sel), t(sc), group_size=G,
                     keep=KEEP)


def test_nm_spmm_has_no_fallback_for_other_devices():
    """Dispatch is by the tensor's device: only a CPU tensor takes the
    plain version; anything else launches a kernel or raises."""
    q, sel, sc = _compressed(32, 8, 0)
    x = torch.empty((4, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.nm_spmm(x, t(q), t(sel), t(sc), group_size=G, keep=KEEP)


def test_cuda_wrapper_checks_before_launching():
    """The kernel's wrapper refuses what the kernel does not take — here
    CPU tensors — without building or launching anything."""
    q, sel, sc = _compressed(32, 8, 0)
    before = tk.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.nm_spmm_cuda(t(_x((4, 32), 0)), t(q), t(sel), t(sc),
                        group_size=G, keep=KEEP)
    assert tk.launches == before



# ---------------------------------------------------------------------------
# quant_matmul and sparse_conv1d (the kernel benchmark's other two kernels)
# ---------------------------------------------------------------------------


def _packed(k: int, nn: int, bits: int, seed: int):
    """uint8 packed planes and (1, N) f32 scale — numpy, via the JAX
    quantizer (the port's is bit-identical, tests/test_torch_core.py)."""
    w = np.random.default_rng(seed).standard_normal((k, nn)).astype(np.float32)
    q, scale = JQ.quantize(jnp.asarray(w), JQ.QuantConfig(bits=bits))
    return n(JQ.pack_planes(q, bits)), n(scale).reshape(1, -1)


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
@pytest.mark.parametrize("m,k,nn", [(8, 64, 16), (33, 128, 40)])
def test_quant_matmul_matches_jax(bits, m, k, nn):
    packed, sc = _packed(k, nn, bits, bits)
    x = _x((m, k), 9)
    xj, pj, sj = jnp.asarray(x), jnp.asarray(packed), jnp.asarray(sc)
    want = {
        "ops": jops.quant_matmul(xj, pj, sj, bits=bits),
        "quant_matmul_ref": jref.quant_matmul_ref(xj, pj, sj, bits=bits, k=k),
        "bitserial_matmul_ref": jref.bitserial_matmul_ref(xj, pj, sj,
                                                          bits=bits, k=k),
    }
    y = tops.quant_matmul(t(x), t(packed), t(sc), bits=bits)
    y_ref = tref.quant_matmul_ref(t(x), t(packed), t(sc), bits=bits, k=k)
    assert y.dtype == torch.float32 and tuple(y.shape) == (m, nn)
    for got in (y, y_ref):
        for name, y_jax in want.items():
            np.testing.assert_allclose(n(got), n(y_jax), rtol=TOL, atol=TOL,
                                       err_msg=name)


@pytest.mark.parametrize("ks,stride,c,nn,tt", [
    (7, 2, 4, 16, 512),   # VA layer 0
    (5, 2, 24, 32, 256),  # VA layer 1-ish
    (3, 1, 32, 48, 128),
    (1, 1, 96, 2, 16),    # 1x1 head
])
def test_sparse_conv1d_matches_jax(ks, stride, c, nn, tt):
    k_dense = -(-(ks * c) // G) * G
    q, sel, sc = _compressed(k_dense, nn, ks)
    x = _x((2, tt, c), 3)
    args_j = (jnp.asarray(x), jnp.asarray(q), jnp.asarray(sel), jnp.asarray(sc))
    kw = dict(ksize=ks, stride=stride, group_size=G, keep=KEEP)
    y_jax = jops.sparse_conv1d(*args_j, **kw)
    y_jref = jref.sparse_conv1d_ref(*args_j, **kw)
    y = tops.sparse_conv1d(t(x), t(q), t(sel), t(sc), **kw)
    y_ref = tref.sparse_conv1d_ref(t(x), t(q), t(sel), t(sc), **kw)
    assert tuple(y.shape) == (2, (tt - 1) // stride + 1, nn)
    assert y.dtype == torch.float32
    for got in (y, y_ref):
        np.testing.assert_allclose(n(got), n(y_jax), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(n(got), n(y_jref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_unpack_tile_identical(bits):
    packed = np.random.default_rng(bits).integers(0, 256, (12, 7), np.uint8)
    uj = jcommon.unpack_tile(jnp.asarray(packed), bits)
    ut = tcommon.unpack_tile(t(packed), bits)
    assert ut.dtype == torch.int32 and n(uj).dtype == np.int32
    np.testing.assert_array_equal(n(ut), n(uj))


def test_sparse_conv1d_equals_im2col_then_nm_spmm():
    """The fused layer is `execute`'s im2col -> pad -> nm_spmm, before
    bias, on a narrow VA layer compiled by the port."""
    from _torch_bridge import CPU, configs, np_params
    from repro_torch import convert
    from repro_torch.core import compiler as tc

    _, cfg = configs(False)
    params = convert.params_from_numpy(np_params(cfg.layers, 5), device=CPU)
    layer = tc.compile_model(params, cfg).layers["conv1"]
    ks, stride = 5, 2  # conv1 of the narrow stack: 16 -> 24 channels
    x = t(_x((2, 256, 16), 4))
    kw = dict(group_size=G, keep=KEEP)
    flat = tspe.im2col(x, ks, stride)
    flat = torch.nn.functional.pad(flat, (0, layer.k_dense - flat.shape[-1]))
    want = tops.nm_spmm(flat, layer.values_q, layer.select, layer.scale, **kw)
    got = tops.sparse_conv1d(x, layer.values_q, layer.select, layer.scale,
                             ksize=ks, stride=stride, **kw)
    assert tuple(got.shape) == (2, 128, 24)
    np.testing.assert_allclose(n(got), n(want), rtol=TOL, atol=TOL)


def test_kernel_benchmark_rows_on_cpu():
    """The ported benchmark runs the reference's rows, in its order, with
    its derived columns (its own asserts hold every output to the oracle)."""
    from repro_torch.benchmarks import kernels as bench

    rows = bench.run(device="cpu")
    assert [r[0] for r in rows] == [
        "kernels.nm_spmm", "kernels.quant_matmul_8b", "kernels.quant_matmul_4b",
        "kernels.quant_matmul_2b", "kernels.quant_matmul_1b",
        "kernels.sparse_conv1d",
    ]
    assert all(us > 0 for _, us, _ in rows)
    assert rows[0][2] == "hbm_bytes=99328 vs_dense_f32=524288 (5.28x)"
    assert rows[4][2] == "hbm_bytes=17408 (30.12x)"


def _conv_args(device="cpu"):
    q, sel, sc = _compressed(32, 16, 0)
    x = torch.zeros((2, 64, 4), device=device)
    return x, t(q), t(sel), t(sc)


def _qm_args(device="cpu"):
    packed, sc = _packed(64, 16, 4, 0)
    return torch.zeros((4, 64), device=device), t(packed), t(sc)


@pytest.mark.parametrize("op", ["quant_matmul", "sparse_conv1d"])
def test_new_wrappers_have_no_fallback_for_other_devices(op):
    with pytest.raises(ValueError, match="no kernel for device"):
        if op == "quant_matmul":
            tops.quant_matmul(*_qm_args("meta"), bits=4)
        else:
            tops.sparse_conv1d(*_conv_args("meta"), ksize=7, stride=2,
                               group_size=G, keep=KEEP)


@pytest.mark.parametrize("op", ["quant_matmul", "sparse_conv1d"])
def test_new_cuda_wrappers_check_before_building(op):
    """CPU tensors are refused before any build or launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import quant_matmul as tqm
    from repro_torch.kernels import sparse_conv1d as tsc

    mod = tqm if op == "quant_matmul" else tsc
    before = mod.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        if op == "quant_matmul":
            tqm.quant_matmul_cuda(*_qm_args(), bits=4)
        else:
            tsc.sparse_conv1d_cuda(*_conv_args(), ksize=7, stride=2,
                                   group_size=G, keep=KEEP)
    assert mod.launches == before
    assert op not in _build._LOADED


@pytest.mark.parametrize("case", ["quant_k", "quant_bits", "conv_k_dense"])
def test_new_wrappers_reject_bad_geometry(case):
    if case == "quant_k":  # 4-bit: 32 packed rows hold K = 64, not 48
        x, packed, sc = _qm_args()
        with pytest.raises(ValueError, match="K=48"):
            tops.quant_matmul(x[:, :48], packed, sc, bits=4)
    elif case == "quant_bits":
        x, packed, sc = _qm_args()
        with pytest.raises(ValueError, match="bits must be one of"):
            tops.quant_matmul(x, packed, sc, bits=3)
    else:  # Kk = 16 covers a dense K of 32 < ksize * C = 7 * 8
        _, q, sel, sc = _conv_args()
        with pytest.raises(ValueError, match="k_dense=32"):
            tops.sparse_conv1d(torch.zeros((2, 64, 8)), q, sel, sc, ksize=7,
                               stride=2, group_size=G, keep=KEEP)

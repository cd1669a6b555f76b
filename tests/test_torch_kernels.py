"""PyTorch port's `nm_spmm` vs the JAX package's, and the CUDA kernel vs
its plain version.

On this CPU host the port's `ops.nm_spmm` dispatches to the plain
version (decompress + one float32 matmul) and the JAX one runs its Pallas
kernel in interpret mode, as the JAX suite does. Both are held to
1e-4 — the float32 tolerance of tests/test_kernels.py: the two sum in
different orders. The CUDA kernel itself runs only on a card
(tests/test_torch_cuda.py).
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


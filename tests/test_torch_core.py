"""PyTorch port vs JAX package: quantization, balanced sparsity, perf model.

Same numpy inputs through `repro.core.*` and `repro_torch.core.*`. The
integer outputs (codes, masks, selects, packed words) must be
bit-identical; float sums may differ in summation order only, hence 1e-5
in float32 where a sum is taken.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import n, t

from repro.core import perf_model as jpm
from repro.core import quant as JQ
from repro.core import sparsity as JS
from repro.core import vadetect as jva
from repro_torch.core import perf_model as tpm
from repro_torch.core import quant as TQ
from repro_torch.core import sparsity as TS
from repro_torch.core import vadetect as tva

CFG_J = JS.SparsityConfig(16, 8)
CFG_T = TS.SparsityConfig(16, 8)


def _weights(kind: str, k: int = 64, nn: int = 12, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, nn)).astype(np.float32)
    if kind == "tied":
        # many equal |w| inside every group: ranking must break ties by
        # position, as jnp.argsort's stable sort does
        w = (np.round(w * 2) / 2).astype(np.float32)
        w[:16:2, 0] = 0.5
        w[1:16:2, 0] = -0.5
    if kind == "zero_column":
        w[:, 3] = 0.0  # the finfo.tiny guard of the scale
    return w


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
@pytest.mark.parametrize("kind", ["random", "zero_column"])
def test_quantize_dequantize_identical(bits, kind):
    w = _weights(kind)
    qj, sj = JQ.quantize(jnp.asarray(w), JQ.QuantConfig(bits=bits))
    qt, st = TQ.quantize(t(w), TQ.QuantConfig(bits=bits))
    np.testing.assert_array_equal(n(qt), n(qj))
    assert n(qt).dtype == np.int8
    st_np, sj_np = n(st), n(sj)
    if kind == "zero_column":
        # an all-zero channel's scale is finfo.tiny / qmax, a subnormal
        # at 4 and 8 bits: XLA flushes it to 0, and so does the port
        np.testing.assert_array_equal(st_np[:, 3], sj_np[:, 3])
        assert st_np[0, 3] == (0.0 if bits >= 4 else np.finfo(np.float32).tiny)
    if bits == 1:  # scale is a mean: summation order, f32
        np.testing.assert_allclose(st_np, sj_np, rtol=1e-6)
    else:  # max / qmax: exact
        np.testing.assert_array_equal(st_np, sj_np)
    np.testing.assert_array_equal(
        n(TQ.dequantize(qt, t(n(sj)))), n(JQ.dequantize(qj, sj))
    )


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_pack_unpack_planes_identical(bits):
    w = _weights("random", k=37, nn=5, seed=bits)  # K not a byte multiple
    q, _ = JQ.quantize(jnp.asarray(w), JQ.QuantConfig(bits=bits))
    pj = JQ.pack_planes(q, bits)
    pt = TQ.pack_planes(t(n(q)), bits)
    np.testing.assert_array_equal(n(pt), n(pj))
    assert n(pt).dtype == np.uint8
    np.testing.assert_array_equal(n(TQ.unpack_planes(pt, bits, 37)), n(q))


@pytest.mark.parametrize("kind", ["random", "tied"])
def test_prune_mask_and_compress_identical(kind):
    w = _weights(kind, k=60)  # a trailing partial group for the mask
    mj = JS.balanced_prune_mask(jnp.asarray(w), CFG_J)
    mt = TS.balanced_prune_mask(t(w), CFG_T)
    np.testing.assert_array_equal(n(mt), n(mj))
    wp = np.pad(w, ((0, 4), (0, 0)))  # whole groups for compress
    pj = JS.apply_prune(jnp.asarray(wp), CFG_J)
    pt = TS.apply_prune(t(wp), CFG_T)
    np.testing.assert_array_equal(n(pt), n(pj))
    vj, sj = JS.compress(pj, CFG_J)
    vt, st = TS.compress(pt, CFG_T)
    np.testing.assert_array_equal(n(vt), n(vj))
    np.testing.assert_array_equal(n(st), n(sj))
    assert n(st).dtype == np.uint8
    np.testing.assert_array_equal(n(TS.decompress(vt, st, CFG_T, 64)), n(pj))
    assert TS.verify_balance(TS.balanced_prune_mask(t(wp), CFG_T), CFG_T)
    assert not TS.verify_balance(torch.ones((64, 12), dtype=torch.bool), CFG_T)


def test_sparse_matmul_ref_matches():
    w = _weights("random", k=64)
    vj, sj = JS.compress(JS.apply_prune(jnp.asarray(w), CFG_J), CFG_J)
    x = np.random.default_rng(5).standard_normal((3, 7, 64)).astype(np.float32)
    yj = JS.sparse_matmul_ref(jnp.asarray(x), vj, sj, CFG_J)
    # select passed as uint8: a uint8 index would be a boolean mask in torch
    yt = TS.sparse_matmul_ref(t(x), t(n(vj)), t(n(sj)), CFG_T)
    np.testing.assert_allclose(n(yt), n(yj), rtol=1e-5, atol=1e-5)


def test_straight_through_gradients():
    w = t(_weights("random")).requires_grad_(True)
    g = torch.arange(w.numel(), dtype=torch.float32).reshape(w.shape)
    TQ.fake_quant(w, 4, True).backward(g)
    np.testing.assert_array_equal(n(w.grad), n(g))
    w.grad = None
    TS.prune_ste(w, 16, 8).backward(g)
    np.testing.assert_array_equal(n(w.grad), n(g))


@pytest.mark.parametrize("layer_bits", [None, (8, 8, 4, 4, 4, 4, 8, 8)])
def test_chip_report_field_by_field(layer_bits):
    meta_j = jva.layer_shapes(jva.VAConfig(layer_bits=layer_bits))
    meta_t = tva.layer_shapes(tva.VAConfig(layer_bits=layer_bits))
    assert meta_t == meta_j

    def report(pm, meta):
        return pm.chip_report([
            pm.LayerWorkload(**{
                f.name: m[f.name] for f in dataclasses.fields(pm.LayerWorkload)
            })
            for m in meta
        ])

    rj, rt = report(jpm, meta_j), report(tpm, meta_t)
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
    assert rt.summary() == rj.summary()

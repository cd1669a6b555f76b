"""PyTorch port vs JAX package: the VA detector, its compiler and the
chip-format execution, on a narrow stack (two sparse layers + the dense
head, 512 samples, batch 4) and the same numpy weights.

The compiled program must be bit-identical. Logits are held to 1e-4:
the same float32 arithmetic summed in another order. The JAX side runs
under `jax.jit`: one compile per call instead of one per op.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import CPU, configs, n, np_params, np_signals, t

from repro.core import compiler as jc
from repro.core import spe as jspe
from repro.core import vadetect as jva
from repro_torch import convert
from repro_torch.core import compiler as tc
from repro_torch.core import spe as tspe
from repro_torch.core import vadetect as tva

TOL = 1e-4


def _both(mixed: bool, seed: int = 0):
    """(jax cfg, port cfg, jax params, port params) from one numpy tree."""
    cfg_j, cfg_t = configs(mixed)
    tree = np_params(cfg_t.layers, seed)
    params_j = {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in tree.items()}
    return cfg_j, cfg_t, params_j, convert.params_from_numpy(tree, device=CPU)


@functools.lru_cache(maxsize=None)
def _programs(mixed: bool):
    """`_both(mixed)` plus both packages' compiled programs, built once."""
    cfg_j, cfg_t, pj, pt = _both(mixed)
    return cfg_j, cfg_t, pj, pt, jc.compile_model(pj, cfg_j), tc.compile_model(pt, cfg_t)


def test_params_from_numpy_round_trip():
    tree = np_params(tva.VA_LAYERS, 3)
    params = convert.params_from_numpy(tree, device="cpu")
    assert params.keys() == tree.keys()
    for name, layer in tree.items():
        for k, v in layer.items():
            assert params[name][k].dtype == torch.float32
            np.testing.assert_array_equal(n(params[name][k]), v)
    assert tva.param_count(params) == sum(v.size for d in tree.values() for v in d.values())


@pytest.mark.parametrize("mixed", [False, True], ids=["paper_8bit", "mixed"])
def test_compile_model_identical(mixed):
    _, _, _, _, prog_j, prog_t = _programs(mixed)
    assert prog_t.layer_meta == prog_j.layer_meta
    for name, lj in prog_j.layers.items():
        lt = prog_t.layers[name]
        for field in ("values_q", "select", "scale", "packed_planes"):
            a, b = n(getattr(lt, field)), n(getattr(lj, field))
            assert a.dtype == b.dtype, (name, field)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{field}")
        for field in ("bits", "group_size", "keep", "k_dense", "sparse"):
            assert getattr(lt, field) == getattr(lj, field)
        assert lt.hbm_bytes() == lj.hbm_bytes()
    assert prog_t.compression_ratio() == prog_j.compression_ratio()
    assert prog_t.report.summary() == prog_j.report.summary()


@pytest.mark.parametrize("path", ["reference", "kernel", "dense"])
def test_execute_matches_jax(path):
    cfg_j, cfg_t, _, _, prog_j, prog_t = _programs(False)
    x = np_signals(4, 2)
    y_j = n(jax.jit(lambda v: jc.execute(prog_j, v, cfg_j, path=path))(x))
    y_t = n(tc.execute(prog_t, t(x), cfg_t, path=path))
    assert y_t.shape == (4, 2)
    np.testing.assert_allclose(y_t, y_j, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(y_t.argmax(-1), y_j.argmax(-1))


@pytest.mark.parametrize("mixed", [False, True], ids=["paper_8bit", "mixed"])
def test_apply_eval_matches_jax(mixed):
    cfg_j, cfg_t, pj, pt, _, prog_t = _programs(mixed)
    x = np_signals(4, 5)
    y_j = n(jax.jit(lambda v: jva.apply(pj, v, cfg_j, train=False))(x))
    y_t = n(tva.apply(pt, t(x), cfg_t, train=False))
    np.testing.assert_allclose(y_t, y_j, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(n(tva.predict(pt, t(x), cfg_t)), y_j.argmax(-1))
    # and the compiled program agrees with eval (test_vadetect.py's 2e-2)
    y_chip = n(tc.execute(prog_t, t(x), cfg_t))
    np.testing.assert_allclose(y_chip, y_t, rtol=2e-2, atol=2e-2)


def test_im2col_order_conv0_shaped():
    """ks=7, C_in=4, stride 2 — conv0. `Tensor.unfold` puts the window
    last; without the permute to (tap, channel) the shapes still match but
    the matmul disagrees with the convolution and with the reference."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((7, 4, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    x = rng.standard_normal((2, 512, 4)).astype(np.float32)
    params_t = {"w": t(w), "b": t(b)}
    y_mm = n(tspe.conv1d_as_matmul(params_t, t(x), stride=2))
    y_conv = n(tspe.conv1d_apply(params_t, t(x), None, stride=2))
    y_jax = n(jspe.conv1d_as_matmul({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                    jnp.asarray(x), stride=2))
    assert y_mm.shape == (2, 256, 16)
    np.testing.assert_allclose(y_mm, y_conv, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y_mm, y_jax, rtol=TOL, atol=TOL)
    # the patch of output position 1 is input rows 0..6 (pad_l = 2),
    # flattened tap-major
    patches = n(tspe.im2col(t(x), 7, 2))
    np.testing.assert_array_equal(patches[0, 1], x[0, 0:7].reshape(-1))


def test_vote_diagnose_and_shapes():
    assert int(tva.vote(torch.tensor([1, 1, 1, 0, 0, 0]))) == 1  # tie -> VA
    assert int(tva.vote(torch.tensor([0, 0, 0, 0, 1, 1]))) == 0
    assert int(tva.vote(torch.tensor([1, 1, 1, 1, 0, 1]))) == 1
    cfg_j, cfg_t, pj, pt, _, _ = _programs(False)
    recs = np_signals(3, 9, segments=6)
    d_t = n(tva.diagnose(pt, t(recs), cfg_t))
    d_j = n(jax.jit(lambda v: jva.diagnose(pj, v, cfg_j))(recs))
    assert d_t.shape == (3,)
    np.testing.assert_array_equal(d_t, d_j)
    assert tva.layer_shapes(tva.VAConfig()) == jva.layer_shapes(jva.VAConfig())


def test_init_is_seeded_and_full_width():
    a = tva.init(torch.Generator().manual_seed(0), device="cpu")
    b = tva.init(torch.Generator().manual_seed(0), device="cpu")
    assert a.keys() == {f"conv{i}" for i in range(8)}
    for name in a:
        torch.testing.assert_close(a[name]["w"], b[name]["w"], rtol=0, atol=0)
    assert 10_000 < tva.param_count(a) < 100_000
    assert a["conv0"]["w"].shape == (7, tva.N_INPUT_PAD, 16)

"""Numpy bridge shared by the tests that hold the PyTorch port
(`repro_torch`) against the JAX package (`repro`).

Inputs are made with numpy from a seed and handed to both packages;
outputs come back as numpy. JAX stays on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import torch

from repro import configs as jconfigs
from repro.core import spe as jspe
from repro.core import vadetect as jva
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import spe as tspe
from repro_torch.core import vadetect as tva
from repro_torch.models import api as tapi

CPU = torch.device("cpu")
# a narrow VA stack: two sparse layers and the dense 1x1 head, 512 samples
NARROW = ((16, 7, 2), (24, 5, 2), (2, 1, 1))
NARROW_MIXED_BITS = (8, 4, 8)


def configs(mixed: bool = False):
    """(jax VAConfig, port VAConfig) of the narrow stack, 8-bit or mixed."""
    bits = NARROW_MIXED_BITS if mixed else None
    return (
        jva.VAConfig(layers=NARROW, spe=jspe.SPEConfig(), layer_bits=bits),
        tva.VAConfig(layers=NARROW, spe=tspe.SPEConfig(), layer_bits=bits),
    )


def np_params(layers, seed: int) -> dict:
    """He-normal weights and small random biases, as numpy float32."""
    rng = np.random.default_rng(seed)
    tree, c_in = {}, tva.N_INPUT_PAD
    for i, (c_out, ks, _) in enumerate(layers):
        w = rng.standard_normal((ks, c_in, c_out)) * np.sqrt(2.0 / (ks * c_in))
        b = rng.standard_normal((c_out,)) * 0.05
        tree[f"conv{i}"] = {"w": w.astype(np.float32), "b": b.astype(np.float32)}
        c_in = c_out
    return tree


def np_signals(batch: int, seed: int, segments: int | None = None) -> np.ndarray:
    """Band-limited-looking random records, float32 (B, 512) or
    (B, segments, 512)."""
    rng = np.random.default_rng(seed)
    shape = (batch, 512) if segments is None else (batch, segments, 512)
    return rng.standard_normal(shape).astype(np.float32)


def program_arrays(jprog) -> tuple[dict, dict, list]:
    """A JAX AcceleratorProgram as the numpy (layers, biases, layer_meta)
    that `repro_torch.convert.program_from_numpy` takes."""
    layers = {
        name: {
            "values_q": np.asarray(l.values_q),
            "select": np.asarray(l.select),
            "scale": np.asarray(l.scale),
            "packed_planes": np.asarray(l.packed_planes),
            "bits": l.bits,
            "group_size": l.group_size,
            "keep": l.keep,
            "k_dense": l.k_dense,
            "sparse": l.sparse,
        }
        for name, l in jprog.layers.items()
    }
    biases = {k: np.asarray(b) for k, b in jprog.biases.items()}
    return layers, biases, [dict(m) for m in jprog.layer_meta]


# the dense decoder families the port serves (reduced configs)
DENSE_LM = ("qwen3_8b", "qwen3_14b", "codeqwen15_7b", "gemma2_9b",
            "qwen2_vl_72b")


def lm_models(name: str, dtype: str = "bfloat16", max_seq: int = 32,
              seed: int = 0, **overrides):
    """(jax model, port model, jax params, port params) of a reduced LM
    config at `dtype`: the JAX package's init from `seed`, carried across
    as numpy with `convert.lm_params_from_numpy`."""
    jcfg = dataclasses.replace(jconfigs.reduced(name), dtype=dtype, **overrides)
    tcfg = dataclasses.replace(tconfigs.reduced(name), dtype=dtype, **overrides)
    mj = japi.build_model(jcfg, tp=1, max_seq=max_seq)
    mt = tapi.build_model(tcfg, tp=1, max_seq=max_seq)
    pj = mj.init(jax.random.PRNGKey(seed))
    pt = convert.lm_params_from_numpy(jax.tree.map(np.asarray, pj), device=CPU)
    return mj, mt, pj, pt


@functools.lru_cache(maxsize=None)
def _lm_weights(name: str, max_seq: int):
    _, _, pj, pt = lm_models(name, "float32", max_seq=max_seq)
    return pj, pt


@functools.lru_cache(maxsize=None)
def shared_lm_models(name: str, dtype: str = "float32", max_seq: int = 40):
    """`lm_models` with the weights drawn once a process (they do not
    depend on the compute dtype) and each model built once: every caller
    gets the same objects, so the reference's jit caches hit across
    tests. Callers must not write the params."""
    pj, pt = _lm_weights(name, max_seq)
    jcfg = dataclasses.replace(jconfigs.reduced(name), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.reduced(name), dtype=dtype)
    return (japi.build_model(jcfg, tp=1, max_seq=max_seq),
            tapi.build_model(tcfg, tp=1, max_seq=max_seq), pj, pt)


def np_tokens(shape, vocab: int, seed: int) -> np.ndarray:
    """Token ids in [0, vocab), int32."""
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def t(a, dtype=None) -> torch.Tensor:
    """numpy -> CPU tensor (copy)."""
    return torch.from_numpy(np.array(a, dtype=dtype))


def n(x) -> np.ndarray:
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

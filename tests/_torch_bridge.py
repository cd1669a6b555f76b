"""Numpy bridge shared by the tests that hold the PyTorch port
(`repro_torch`) against the JAX package (`repro`).

Inputs are made with numpy from a seed and handed to both packages;
outputs come back as numpy. JAX stays on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from repro.core import spe as jspe
from repro.core import vadetect as jva
from repro_torch.core import spe as tspe
from repro_torch.core import vadetect as tva

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


def t(a, dtype=None) -> torch.Tensor:
    """numpy -> CPU tensor (copy)."""
    return torch.from_numpy(np.array(a, dtype=dtype))


def n(x) -> np.ndarray:
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

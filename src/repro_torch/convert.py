"""Carry weights across from the JAX package, as numpy arrays.

The JAX package's parameters and compiled programs are pytrees of arrays;
`np.asarray` on each leaf gives what these functions take, so both
packages can compute from the same weights without this one importing
jax. Layouts are the same on both sides.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core.compiler import AcceleratorProgram, chip_report
from repro_torch.core.spe import CompiledLayer

# CompiledLayer's array fields and the dtype each must have
_LAYER_ARRAYS = {
    "values_q": np.int8,
    "select": np.uint8,
    "scale": np.float32,
    "packed_planes": np.uint8,
}


def _tensor(a, dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def params_from_numpy(
    tree: Mapping[str, Mapping[str, np.ndarray]],
    device: _device.DeviceLike = None,
) -> dict:
    """{"conv{i}": {"w": (ks, c_in, c_out), "b": (c_out,)}} numpy ->
    the port's float32 parameters on `device`."""
    dev = _device.resolve(device)
    return {
        name: {k: _tensor(v, np.float32, dev) for k, v in layer.items()}
        for name, layer in tree.items()
    }


def program_from_numpy(
    layers: Mapping[str, Mapping],
    biases: Mapping[str, np.ndarray],
    layer_meta: list[dict],
    device: _device.DeviceLike = None,
) -> AcceleratorProgram:
    """A compiled program from numpy: `layers[name]` holds the
    `CompiledLayer` fields (arrays `values_q`, `select`, `scale`,
    `packed_planes`; ints/bools `bits`, `group_size`, `keep`, `k_dense`,
    `sparse`). The perf-model report is recomputed from `layer_meta`."""
    dev = _device.resolve(device)
    compiled = {
        name: CompiledLayer(
            **{k: _tensor(f[k], dt, dev) for k, dt in _LAYER_ARRAYS.items()},
            bits=int(f["bits"]),
            group_size=int(f["group_size"]),
            keep=int(f["keep"]),
            k_dense=int(f["k_dense"]),
            sparse=bool(f["sparse"]),
        )
        for name, f in layers.items()
    }
    meta = [dict(m) for m in layer_meta]
    return AcceleratorProgram(
        layers=compiled,
        biases={k: _tensor(b, np.float32, dev) for k, b in biases.items()},
        layer_meta=meta,
        report=chip_report(meta),
    )

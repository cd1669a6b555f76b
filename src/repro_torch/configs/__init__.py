"""Config registry: the paper's va_cnn + 10 assigned LM architectures.

Port of `repro.configs`. Every LM module exposes CONFIG (the exact
assigned dims) and REDUCED (a same-family small config for CPU tests);
`get(name)` / `reduced(name)` look them up, by module name or by CLI id;
`ALL_ARCHS` lists the assigned ten. The architecture modules are copies
of the reference's (plain dataclasses); `va_cnn` holds the port's own
VA operating points.
"""

from __future__ import annotations

import importlib

from repro_torch.configs import va_cnn
from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    MoESpec,
    ShapeCell,
    applicable_shapes,
)

ALL_ARCHS = (
    "rwkv6_3b",
    "recurrentgemma_2b",
    "whisper_tiny",
    "codeqwen15_7b",
    "qwen3_8b",
    "qwen3_14b",
    "gemma2_9b",
    "llama4_scout_17b_a16e",
    "olmoe_1b_7b",
    "qwen2_vl_72b",
)

# CLI ids (--arch) use dashes, matching the assignment sheet.
CLI_IDS = {
    "rwkv6-3b": "rwkv6_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-tiny": "whisper_tiny",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "qwen3-8b": "qwen3_8b",
    "qwen3-14b": "qwen3_14b",
    "gemma2-9b": "gemma2_9b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}


def _module(name: str):
    mod = CLI_IDS.get(name, name).replace("-", "_").replace(".", "")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def reduced(name: str) -> ArchConfig:
    return _module(name).REDUCED


__all__ = [
    "ALL_ARCHS",
    "CLI_IDS",
    "SHAPES",
    "ArchConfig",
    "MoESpec",
    "ShapeCell",
    "applicable_shapes",
    "get",
    "reduced",
    "va_cnn",
]

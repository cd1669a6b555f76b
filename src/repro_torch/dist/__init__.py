"""Distributed execution (port of `repro.dist`): sharding rules, gradient
accumulation, compressed cross-pod collectives.

  sharding    — mesh-aware partition rules for params / batches / caches
                as pure functions of shapes and axis sizes, and this
                rank's block under a spec (`shard_local`); the logical
                activation constraints (`constrain`,
                `activation_context`) are ROADMAP.md queue 1 item 8b;
  accumulate  — micro-batch gradient accumulation;
  compression — int8 + error-feedback gradient reduction over the pod
                group (`torch.distributed`: NCCL on the card, gloo on
                the CPU).
"""

from repro_torch.dist import accumulate, compression, sharding
from repro_torch.dist.accumulate import accumulate_grads
from repro_torch.dist.sharding import (
    batch_specs,
    cache_specs,
    data_axes,
    named,
    param_specs,
    spec_for_path,
)

__all__ = [
    "accumulate",
    "accumulate_grads",
    "batch_specs",
    "cache_specs",
    "compression",
    "data_axes",
    "named",
    "param_specs",
    "sharding",
    "spec_for_path",
]

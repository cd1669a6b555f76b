"""Distributed execution (port of `repro.dist`): sharding rules, gradient
accumulation, compressed cross-pod collectives.

  sharding    — mesh-aware partition rules for params / batches / caches
                as pure functions of shapes and axis sizes; this rank's
                block under a spec (`shard_local`, `place`); the
                activation context a sharded layer reads its groups
                from, the FSDP gather (`gather_block`), the counted
                collectives with their adjoints (training through the
                placement) and the logical `constrain` checks;
  accumulate  — micro-batch gradient accumulation;
  compression — int8 + error-feedback gradient reduction over the pod
                group (`torch.distributed`: NCCL on the card, gloo on
                the CPU).
"""

from repro_torch.dist import accumulate, compression, sharding
from repro_torch.dist.accumulate import accumulate_grads
from repro_torch.dist.sharding import (
    activation_context,
    batch_specs,
    cache_specs,
    constrain,
    data_axes,
    named,
    param_specs,
    place,
    spec_for_path,
)

__all__ = [
    "accumulate",
    "accumulate_grads",
    "activation_context",
    "batch_specs",
    "cache_specs",
    "compression",
    "constrain",
    "data_axes",
    "named",
    "param_specs",
    "place",
    "sharding",
    "spec_for_path",
]

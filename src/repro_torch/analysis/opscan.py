"""Checks over one cell's recorded call (port of `repro.analysis.hloscan`).

The reference scans the optimized HLO text of a compiled cell. An eager
PyTorch cell has no such program: what it did is recorded while its first
real call runs (`obs.torchprobe.CallRecord`), and these pure functions
read that record, so each check can be tested on a hand-made record.

What each check encodes (the reference's, mapped onto eager ops):

  * **host ops** — decode, stream and train cells must stay on the
    device. The reference's callback custom-calls and infeed / outfeed /
    send / recv become: a read of a tensor's value by the host (`.item()`,
    `int()`, `float()`, `bool()` of a tensor, `torch.equal`), an op whose
    output shape depends on the data (`nonzero`, `masked_select`,
    `unique`, indexing with a boolean mask), host data made a tensor
    (`torch.tensor` / `torch.as_tensor` of a list or an array) and a copy
    between host and device. Each one waits for the card or copies from
    the host on it; the copy between devices shows only on the card.
  * **f64** — any op that reads or makes a float64 tensor.
  * **donation** — a donated argument's storages are the same before and
    after the call, and the outputs hold them: the results were written
    into the argument (the reference's `input_output_alias`), with no
    second copy of the pool.
  * **collectives** — the kinds and counts handed to `torch.distributed`
    during the call, under the reference's HLO names, against the
    declared budget with the reference's rules (`over_budget`).
  * **sharded outputs** — at least one output is a rank-local block:
    its placement spec splits it over a mesh axis of size > 1, so its
    global shape is larger than the local one.
"""

from __future__ import annotations

import math
from typing import Any

import torch


def f64_ops(record) -> list:
    """Names of the ops that read or made a float64 tensor."""
    return list(record.f64)


def host_transfer_ops(record) -> list:
    """Host reads, data-dependent shapes and host <-> device copies, each
    described as recorded."""
    return list(record.host_reads) + list(record.transfers)


def donation_aliased(record, donate) -> bool:
    """True where every donated argument kept its storages through the
    call and the outputs hold all of them."""
    for i in donate:
        d = record.donated.get(i)
        if d is None or d["before"] != d["after"] or not d["in_outputs"]:
            return False
    return True


def collective_counts(record) -> dict:
    """Kind -> calls handed to `torch.distributed` during the call."""
    return {k: int(v) for k, v in record.collectives.items() if v}


def over_budget(counts: dict, budget: dict) -> list:
    """(op, count, allowed) rows where the inventory exceeds the declared
    budget. `budget` maps op name -> max count; ops absent from the budget
    are allowed zero occurrences; an allowance of "*" (or a negative
    count) means unbounded."""
    rows = []
    for op, n in sorted(counts.items()):
        allowed = budget.get(op, 0)
        if allowed == "*" or (isinstance(allowed, int) and allowed < 0):
            continue
        if n > int(allowed):
            rows.append((op, n, int(allowed)))
    return rows


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def global_shapes(record, out_specs: Any, axis_sizes: dict) -> list:
    """(local, global) shape pairs of the output tensors under their specs
    on a mesh of `axis_sizes` (axis name -> size). `out_specs` follows the
    outputs' tree (`CallRecord.outputs`): a list for a tuple of outputs,
    dicts by key, a spec (a tuple: an entry a dim, an axis name, a tuple
    of names, or None) at a tensor; an output the specs do not reach is
    replicated."""
    pairs: list = []

    def walk(shapes, specs) -> None:
        if isinstance(shapes, torch.Size):
            spec = tuple(specs or ())
            spec = spec + (None,) * (len(shapes) - len(spec))
            pairs.append((tuple(shapes), tuple(
                d * math.prod(axis_sizes.get(a, 1) for a in _names(e))
                for d, e in zip(shapes, spec))))
        elif isinstance(shapes, dict):
            for k, v in shapes.items():
                walk(v, specs.get(k) if isinstance(specs, dict) else None)
        elif isinstance(shapes, list):
            for i, v in enumerate(shapes):
                walk(v, specs[i] if isinstance(specs, list)
                     and i < len(specs) else None)

    walk(record.outputs, out_specs)
    return pairs


def outputs_sharded(record, out_specs: Any, axis_sizes: dict) -> bool:
    """True where at least one output is a block smaller than its global
    shape (split over an axis of size > 1)."""
    return any(local != glob for local, glob in
               global_shapes(record, out_specs, axis_sizes))

"""Cell auditor: check every registered cell's static safety properties
from its recorded first call (port of `repro.analysis.cellaudit`).

Walks `obs.torchprobe`'s named-cell registry (`probe.cells()`) and reads
each cell's `CallRecord`, which its `TrackedCell` took while the first
real call ran (the reference re-lowers the cell from the argument avals
captured then; an eager cell has no program to re-lower, and running an
in-place cell twice would change its state). The properties are the
reference's:

  * **captured** — a registered cell that was never called has no
    record; coverage is part of the contract, so that is a violation,
    not a skip.
  * **no host transfers** — no host read of a tensor's value, no output
    shape read from the data, no host data made a tensor and no copy
    between host and device inside the cell (`opscan.host_transfer_ops`).
  * **no f64** — mixed bit width means down, never up.
  * **donation honoured** — a cell declaring `donate=(...)` wrote its
    results into those arguments' storages (`opscan.donation_aliased`).
  * **sharded outputs stay sharded** — a cell declaring
    `sharded_outputs=True` has at least one output that is a rank-local
    block of a larger global tensor. On a mesh whose every axis has size
    1 nothing is split, which is a violation here as the reference's
    auditor reports it for a cell on a 1-device mesh.
  * **collective budget** — the collectives the call handed to
    `torch.distributed` stay within the cell's declared `budget` (absent
    kinds are allowed zero; an undeclared budget records the inventory
    without gating it).

A cell that cannot be audited is itself a violation: `audit_cell` never
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.analysis import opscan


@dataclasses.dataclass
class CellAudit:
    """Audit outcome for one cell; `violations` empty means clean."""

    name: str
    violations: list
    collectives: dict = dataclasses.field(default_factory=dict)
    donation_aliased: Optional[bool] = None

    def to_dict(self) -> dict:
        return {
            "violations": list(self.violations),
            "collectives": dict(self.collectives),
            "donation_aliased": self.donation_aliased,
        }


def audit_cell(info) -> CellAudit:
    """Audit one `obs.torchprobe.CellInfo` (or a `TrackedCell`, whose
    `info` it reads); never raises — a record that cannot be read is
    itself a violation."""
    info = getattr(info, "info", info)
    rec = info.call_record
    if rec is None:
        return CellAudit(name=info.name, violations=[
            "never called: no call recorded, cell is unaudited (warmup "
            "must cover every registered cell)"
        ])
    v = []
    try:
        for op in opscan.host_transfer_ops(rec):
            v.append(f"host transfer op in the recorded call: {op}")
        f64 = opscan.f64_ops(rec)
        if f64:
            v.append(f"{len(f64)} f64 op(s) in the recorded call "
                     f"(first: {f64[0]})")
        aliased = None
        if info.donate:
            aliased = opscan.donation_aliased(rec, info.donate)
            if not aliased:
                v.append(
                    f"declared donate={tuple(info.donate)} but the results "
                    f"were not written into the donated storages — "
                    f"donation dropped")
        counts = opscan.collective_counts(rec)
        if info.budget is not None:
            for op, n, allowed in opscan.over_budget(counts, info.budget):
                v.append(
                    f"collective budget exceeded: {op} x{n} > {allowed} "
                    f"(declared budget {info.budget})")
        if info.sharded_outputs:
            from repro_torch.dist import sharding as shd

            sizes = shd.axis_sizes(info.mesh) if info.mesh is not None \
                else {}
            if info.out_specs is None or not opscan.outputs_sharded(
                    rec, info.out_specs, sizes):
                v.append("declared sharded_outputs but every output is "
                         "fully replicated")
    except Exception as e:  # noqa: BLE001 — report, don't crash the audit
        return CellAudit(name=info.name, violations=v + [
            f"audit of the recorded call failed: {type(e).__name__}: {e}"])
    return CellAudit(name=info.name, violations=v, collectives=counts,
                     donation_aliased=aliased)


def audit_cells(cells=None) -> dict:
    """name -> CellAudit over `cells` (default: the live probe's
    registry)."""
    if cells is None:
        from repro_torch import obs

        cells = obs.get().probe.cells()
    return {name: audit_cell(info) for name, info in cells.items()}


def audit_section(cells=None) -> dict:
    """JSON-able BENCH record section; benchmarks attach this under
    "cell_audit" and assert violations_total == 0."""
    audits = audit_cells(cells)
    return {
        "n_cells": len(audits),
        "violations_total": sum(
            len(a.violations) for a in audits.values()
        ),
        "cells": {name: a.to_dict() for name, a in audits.items()},
    }

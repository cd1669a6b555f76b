"""`repro_torch.analysis`: the port's static analysis (port of
`repro.analysis`). Two halves:

  * **AST rule pack** (`astpass`, `rules`): the reference's six rules
    that apply to any Python, unchanged in behaviour, and a torch
    counterpart of each of its four JAX rules — `global-rng`,
    `host-sync-in-cell`, `numpy-in-cell` and `track-donate-pool` (the
    `rules` docstring maps them). CLI: `python -m repro_torch.analysis
    [paths] [--json OUT]`; exit 0 clean, 1 on unsuppressed findings, 2
    on usage errors, an unreadable baseline or a stale one.
    Suppression: `# repro: allow[rule-id] reason` on (or one line
    above) the flagged line — the reference's syntax, so one pragma
    silences both scanners — or an entry of `analysis/baseline.json`,
    which must still match a live finding.
  * **Compiled-cell auditor** (`cellaudit`, `opscan`): walks the
    `obs.torchprobe` named-cell registry after a benchmark's warm-up and
    checks, from each cell's recorded first call, the properties the
    reference asserts of its jitted cells: the cell was called, no host
    read or host transfer inside it, no float64, donations honoured,
    declared-sharded outputs sharded, and collectives within the cell's
    declared budget. `opscan` holds the checks as pure functions over a
    `CallRecord`.
"""

from __future__ import annotations

from repro_torch.analysis.astpass import (  # noqa: F401
    Finding,
    ScanResult,
    load_baseline,
    scan_paths,
)
from repro_torch.analysis.rules import RULES  # noqa: F401

SCHEMA_VERSION = 1

_AUDIT = ("CellAudit", "audit_cell", "audit_cells", "audit_section")


def __getattr__(name):
    # the audit half imports torch on first use: the lint's CLI and the
    # schema guard run without it
    if name in _AUDIT:
        from repro_torch.analysis import cellaudit

        return getattr(cellaudit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

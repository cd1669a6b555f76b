"""`repro_torch.analysis`: the compiled-cell auditor's counterpart (port of
the audit half of `repro.analysis`).

`cellaudit` walks the `obs.torchprobe` named-cell registry after a
benchmark's warm-up and checks, from each cell's recorded first call,
the properties the reference asserts of its jitted cells: the cell was
called, no host read or host transfer inside it, no float64, donations
honoured, declared-sharded outputs sharded, and collectives within the
cell's declared budget. `opscan` holds the checks as pure functions over
a `CallRecord`.

The AST rule pack (`astpass`, `rules`) is not ported here.
"""

from __future__ import annotations

from repro_torch.analysis.cellaudit import (  # noqa: F401
    CellAudit,
    audit_cell,
    audit_cells,
    audit_section,
)

SCHEMA_VERSION = 1

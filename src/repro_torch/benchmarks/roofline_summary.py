"""Roofline summary over dry-run records (port of
`benchmarks/roofline_summary.py`).

Requires a prior `python -m repro_torch.launch.dryrun` run; prints one
CSV row per recorded (arch x shape) cell with the three terms and the
dominant bottleneck. Skips gracefully when no dry-run output exists. The
terms are modelled at the H100's data-sheet figures, not measured.
"""

from __future__ import annotations

import os

from repro_torch.launch.dryrun import DEFAULT_OUT
from repro_torch.launch.roofline import load_records

DRYRUN_DIR = os.environ.get("REPRO_DRYRUN_DIR", DEFAULT_OUT)
PRODUCTION_MESHES = ("singlepod_16x16", "multipod_2x16x16")


def run() -> list[tuple[str, float, str]]:
    """One (name, us, derived) row a record under `DRYRUN_DIR` (the
    environment's `REPRO_DRYRUN_DIR`, else the dry-run's default): the
    production meshes' first, as the reference's, then any other mesh
    directory it holds; `roofline.missing` where there is none."""
    root = DRYRUN_DIR
    present = set(os.listdir(root)) if os.path.isdir(root) else set()
    meshes = ([m for m in PRODUCTION_MESHES if m in present]
              + sorted(present - set(PRODUCTION_MESHES)))
    rows = []
    for mesh in meshes:
        for r in load_records(root, mesh):
            rf = r["roofline"]
            rows.append((
                f"roofline.{mesh}.{r['arch']}.{r['shape']}",
                rf["bound_s"] * 1e6,
                f"dom={rf['dominant']} frac={rf['roofline_fraction']:.3f} "
                f"useful={rf['useful_flops_ratio']:.3f} "
                f"mem_gib={r['memory']['total_per_device_bytes'] / 2**30:.2f}",
            ))
    if not rows:
        rows.append(("roofline.missing", 0.0,
                     "run `python -m repro_torch.launch.dryrun` first"))
    return rows


def main() -> None:
    for name, us, derived in run():
        print(f"{name},{us:.2f},{derived}")


if __name__ == "__main__":
    main()

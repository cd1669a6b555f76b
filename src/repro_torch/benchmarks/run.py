"""Benchmark orchestrator of the port (port of `benchmarks/run.py`). One
section per paper table/figure:

  table1   — Table 1 (chip power/GOPS/latency/density vs prior works)
  kernels  — SPE/CMUL kernel correctness + bandwidth math
  ablation — compression recipe accuracy (sparsity x bit-width)
  roofline — dry-run roofline summary (when records exist; modelled)

    python -m repro_torch.benchmarks.run

Prints ``name,us_per_call,derived`` CSV; exits 1 if a section failed.
`main(device=None)` runs the kernels and the ablation on the CUDA card
(raises without one); `device="cpu"` runs them on the CPU. The roofline
section reads the records under `roofline_summary.DRYRUN_DIR`, made by
`python -m repro_torch.launch.dryrun`.
"""

from __future__ import annotations

import sys
import traceback

from repro_torch import _device
from repro_torch.benchmarks import ablation, kernels, roofline_summary, table1


def main(device: _device.DeviceLike = None) -> None:
    dev = _device.resolve(device)
    sections = (
        (table1, table1.run),
        (kernels, lambda: kernels.run(dev)),
        (ablation, lambda: ablation.run(device=dev)),
        (roofline_summary, roofline_summary.run),
    )
    print("name,us_per_call,derived")
    failed = []
    for mod, run in sections:
        try:
            for name, us, derived in run():
                print(f"{name},{us:.2f},{derived}")
        except Exception as e:  # noqa: BLE001 — report every section
            failed.append((mod.__name__, repr(e)))
            traceback.print_exc()
    if failed:
        for name, err in failed:
            print(f"{name},nan,FAILED {err}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()

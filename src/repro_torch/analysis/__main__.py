"""CLI: `python -m repro_torch.analysis [paths...] [options]`.

Port of `python -m repro.analysis`. Scans the given paths (default:
`src/repro_torch`, which holds the port's benchmark and example twins,
and `chip_smoke.py`, whichever exist) with the port's rule pack, prints
typed `path:line: rule: message` findings, optionally writes the JSON
report `repro_torch.benchmarks.check_schema` validates, and exits:

    0  clean (no unsuppressed findings, baseline fresh)
    1  unsuppressed findings
    2  usage error / unreadable baseline / stale baseline entries

Default paths, the default baseline
(`src/repro_torch/analysis/baseline.json`, when it exists) and the paths
in findings are those of the checkout that holds this package (`ROOT`),
whatever the working directory: a copy made without `.git` scans itself
and never a tree above it. `--no-fail` reports without gating
(exploration mode); the default gates (`--fail-on-findings` is accepted
as an explicit alias).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch import analysis
from repro_torch.analysis import astpass
from repro_torch.analysis.rules import RULES

BASELINE = Path("src") / "repro_torch" / "analysis" / "baseline.json"
# the checkout: <ROOT>/src/repro_torch/analysis/__main__.py
ROOT = Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's AST rule pack (see the "
                    "repro_torch.analysis.rules docstring)",
    )
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to scan (default: src/repro_torch "
                         "chip_smoke.py)")
    ap.add_argument("--json", metavar="OUT",
                    help="write the JSON analysis report here")
    ap.add_argument("--baseline", metavar="FILE", default=None,
                    help="baseline suppression file (default: "
                         f"{BASELINE} of the checkout that holds this "
                         "package)")
    ap.add_argument("--fail-on-findings", action="store_true",
                    help="exit 1 on unsuppressed findings (the "
                         "default; kept explicit for readability)")
    ap.add_argument("--no-fail", action="store_true",
                    help="report only; always exit 0 unless the "
                         "baseline is stale")
    args = ap.parse_args(argv)

    paths = args.paths or [
        p for p in (ROOT / "src" / "repro_torch", ROOT / "chip_smoke.py")
        if p.exists()
    ]

    baseline, baseline_path = [], args.baseline
    if baseline_path is None:
        default = ROOT / BASELINE
        if default.exists():
            baseline_path = str(default)
    if baseline_path:
        try:
            baseline = astpass.load_baseline(baseline_path)
        except (OSError, ValueError, KeyError) as e:
            print(f"[analysis] unreadable baseline "
                  f"{baseline_path}: {e}", file=sys.stderr)
            return 2

    result = astpass.scan_paths(paths, RULES, baseline=baseline, root=ROOT)

    for f in result.findings:
        print(f"{f.location()}: {f.rule}: {f.message}")
    if args.json:
        report = result.to_report(analysis.SCHEMA_VERSION, RULES)
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)

    if result.stale_baseline:
        for e in result.stale_baseline:
            print(
                f"[analysis] STALE baseline entry (no live finding "
                f"matches): {e['rule']} @ {e['path']}: {e['snippet']!r}",
                file=sys.stderr,
            )
        print(
            f"[analysis] {len(result.stale_baseline)} stale baseline "
            f"entr{'y' if len(result.stale_baseline) == 1 else 'ies'} — "
            f"remove them from {baseline_path}", file=sys.stderr,
        )
        return 2

    n = len(result.findings)
    print(
        f"[analysis] {result.files_scanned} files, {len(RULES)} rules: "
        f"{n} finding(s), {len(result.suppressed)} suppressed"
    )
    if n and not args.no_fail:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

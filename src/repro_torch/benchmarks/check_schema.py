"""Bench-schema guard: every benchmark record must carry the shared
telemetry section (port of `scripts/check_bench_schema.py`).

All benchmark records of the port's twins (`stream_throughput`,
`decode_throughput`, `dist_compression`, `load_sweep`) attach
`repro_torch.obs.telemetry_section()` under the "telemetry" key. A
benchmark that stops doing so — or drifts to a different schema
version — silently rots the cross-benchmark telemetry contract; this
guard turns that into a failure.

    python -m repro_torch.benchmarks.check_schema BENCH_a.json [...]

Exits 1 listing every violation (2 without a file). Checks per record:
  * a "telemetry" dict is present;
  * telemetry["schema_version"] == repro_torch.obs.SCHEMA_VERSION;
  * telemetry was enabled and the shared sub-sections exist
    (counters / gauges / histograms / recompiles). The port's
    `recompiles` counts each tracked cell's distinct call signatures
    (`torchprobe.cache_sizes`), the reference's its jit cache entries:
    the check reads only that it is a dict.

Per-benchmark sections (keyed on the record's "benchmark" name):
  * load_sweep must carry the serving-frontend socket sweep: a
    "frontend" dict with transport == "socket", a numeric admission
    rate, a non-empty points list, the overload verdict block, and the
    socket-vs-inproc transport_overhead pairing.
  * decode_throughput must carry the paged-cache tenancy cell: a
    "paged" dict with the pool geometry, a concurrency_gain >= 2 at
    paged bytes <= dense bytes, the bytes_in_use residency trace
    returning to its initial value after drain, and zero recompiles
    after warmup (the port: no new call signature after the warm-up
    wave).
  * decode_throughput / stream_throughput / dist_compression must
    carry the "cell_audit" section (`repro_torch.analysis.
    audit_section()`: every tracked cell the warm-up registered,
    audited from its recorded first call) with zero violations.

Analysis reports (written by `python -m repro_torch.analysis --json`,
keyed on "report" == "analysis") are validated instead against the
analyzer schema: `repro_torch.analysis.SCHEMA_VERSION`, nonzero
files_scanned, a populated rule catalog, zero live findings and zero
stale baseline entries.

`check_record` checks a record already in memory (`chip_smoke.py`'s
`analysis` phase passes the records its phases built).
"""

from __future__ import annotations

import json
import sys

REQUIRED_KEYS = ("counters", "gauges", "histograms", "recompiles")

# required (key, type) pairs of the load_sweep record's frontend
# (loopback-socket) section — `loadlab.sweep_frontend` output
FRONTEND_KEYS = (
    ("transport", str),
    ("admission_rate_rps", (int, float)),
    ("points", list),
    ("shed_curve", list),
    ("overload", dict),
    ("transport_overhead", dict),
)


def _check_frontend(path: str, rec: dict) -> list[str]:
    fe = rec.get("frontend")
    if not isinstance(fe, dict):
        return [f"{path}: load_sweep record has no 'frontend' "
                f"(loopback-socket sweep) section"]
    errors = []
    for k, typ in FRONTEND_KEYS:
        if not isinstance(fe.get(k), typ):
            errors.append(f"{path}: frontend section missing {k!r}")
    if fe.get("transport") != "socket":
        errors.append(
            f"{path}: frontend transport {fe.get('transport')!r}, "
            f"expected 'socket' (the record must price the real wire)"
        )
    if isinstance(fe.get("points"), list) and not fe["points"]:
        errors.append(f"{path}: frontend points list is empty")
    if not (fe.get("overload") or {}).get("verdict"):
        errors.append(f"{path}: frontend overload verdict missing")
    return errors


# required (key, type) pairs of the decode_throughput record's paged
# (tenancy) section — `decode_throughput.measure_paged` output
PAGED_KEYS = (
    ("page_size", int),
    ("n_pages", int),
    ("span", int),
    ("dense_pool_slots", int),
    ("paged_pool_slots", int),
    ("dense_cache_bytes_total", int),
    ("paged_cache_bytes_total", int),
    ("dense_peak_concurrent", int),
    ("paged_peak_concurrent", int),
    ("concurrency_gain", (int, float)),
    ("bytes_in_use", dict),
    ("recompiles_after_warmup", int),
)


def _check_paged(path: str, rec: dict) -> list[str]:
    pg = rec.get("paged")
    if not isinstance(pg, dict):
        return [f"{path}: decode_throughput record has no 'paged' "
                f"(paged-cache tenancy) section"]
    errors = []
    for k, typ in PAGED_KEYS:
        if not isinstance(pg.get(k), typ):
            errors.append(f"{path}: paged section missing {k!r}")
    gain = pg.get("concurrency_gain")
    if isinstance(gain, (int, float)) and gain < 2.0:
        errors.append(
            f"{path}: paged concurrency_gain {gain} < 2.0 (the "
            f"record must show the tenancy win)"
        )
    if (isinstance(pg.get("paged_cache_bytes_total"), int)
            and isinstance(pg.get("dense_cache_bytes_total"), int)
            and pg["paged_cache_bytes_total"]
            > pg["dense_cache_bytes_total"]):
        errors.append(
            f"{path}: paged pool spends more cache bytes than dense "
            f"({pg['paged_cache_bytes_total']} > "
            f"{pg['dense_cache_bytes_total']}) — the gain must come at "
            f"a fixed byte budget"
        )
    biu = pg.get("bytes_in_use")
    if isinstance(biu, dict):
        for k in ("initial", "peak", "post_drain", "post_drain_final"):
            if not isinstance(biu.get(k), int):
                errors.append(f"{path}: paged bytes_in_use missing {k!r}")
        if (isinstance(biu.get("post_drain_final"), int)
                and isinstance(biu.get("initial"), int)
                and biu["post_drain_final"] != biu["initial"]):
            errors.append(
                f"{path}: paged pool did not drain to its initial "
                f"residency ({biu['post_drain_final']} != "
                f"{biu['initial']}) — leaked pages"
            )
    if pg.get("recompiles_after_warmup") != 0:
        errors.append(
            f"{path}: paged cells met new call signatures after warmup "
            f"({pg.get('recompiles_after_warmup')!r}) — paging broke "
            f"the per-width cell discipline"
        )
    return errors


# benchmarks whose records must carry the repro_torch.analysis cell audit
CELL_AUDIT_BENCHMARKS = (
    "decode_throughput", "stream_throughput", "dist_compression"
)


def _check_cell_audit(path: str, rec: dict) -> list[str]:
    ca = rec.get("cell_audit")
    if not isinstance(ca, dict):
        return [f"{path}: {rec.get('benchmark')} record has no "
                f"'cell_audit' (repro_torch.analysis) section"]
    errors = []
    if not isinstance(ca.get("n_cells"), int) or ca["n_cells"] < 1:
        errors.append(f"{path}: cell_audit covers no cells")
    if ca.get("violations_total") != 0:
        errors.append(
            f"{path}: cell_audit carries "
            f"{ca.get('violations_total')!r} violation(s) — a "
            f"record must audit clean"
        )
    cells = ca.get("cells")
    if not isinstance(cells, dict) or not cells:
        errors.append(f"{path}: cell_audit 'cells' map missing/empty")
        return errors
    if isinstance(ca.get("n_cells"), int) and len(cells) != ca["n_cells"]:
        errors.append(
            f"{path}: cell_audit n_cells {ca['n_cells']} != "
            f"{len(cells)} cells listed"
        )
    for name, cell in cells.items():
        if not isinstance(cell, dict) or not isinstance(
                cell.get("violations"), list):
            errors.append(
                f"{path}: cell_audit cell {name!r} malformed"
            )
        elif cell["violations"]:
            errors.append(
                f"{path}: cell {name!r}: {cell['violations'][0]}"
            )
        if isinstance(cell, dict) and not isinstance(
                cell.get("collectives"), dict):
            errors.append(
                f"{path}: cell {name!r} missing collective inventory"
            )
    return errors


def _check_analysis(path: str, rec: dict) -> list[str]:
    from repro_torch import analysis

    errors = []
    v = rec.get("schema_version")
    if v != analysis.SCHEMA_VERSION:
        errors.append(
            f"{path}: analysis schema_version {v!r}, expected "
            f"{analysis.SCHEMA_VERSION}"
        )
    if not isinstance(rec.get("files_scanned"), int) or (
            rec["files_scanned"] < 1):
        errors.append(f"{path}: analysis report scanned no files")
    rules = rec.get("rules")
    if not isinstance(rules, list) or not rules:
        errors.append(f"{path}: analysis rule catalog missing/empty")
    else:
        for r in rules:
            if not isinstance(r, dict) or not all(
                    isinstance(r.get(k), str)
                    for k in ("id", "summary", "incident")):
                errors.append(
                    f"{path}: malformed rule entry {r!r}"
                )
    if rec.get("findings") != []:
        errors.append(
            f"{path}: analysis report carries live findings — the "
            f"tree must be clean (fix or suppress with a pragma)"
        )
    if rec.get("stale_baseline") != []:
        errors.append(
            f"{path}: analysis baseline is stale (entries no longer "
            f"match live findings — prune the baseline)"
        )
    if not isinstance(rec.get("suppressed"), list):
        errors.append(f"{path}: analysis 'suppressed' list missing")
    return errors


def check_record(path: str, rec, schema_version: int) -> list[str]:
    """Every violation of one record already in memory; `path` names it
    in the messages."""
    if not isinstance(rec, dict):
        return [f"{path}: not a JSON object"]
    if rec.get("report") == "analysis":
        return _check_analysis(path, rec)
    tel = rec.get("telemetry")
    if not isinstance(tel, dict):
        return [f"{path}: no 'telemetry' section"]
    errors = []
    v = tel.get("schema_version")
    if v != schema_version:
        errors.append(
            f"{path}: telemetry schema_version {v!r}, "
            f"expected {schema_version}"
        )
    if not tel.get("enabled"):
        errors.append(f"{path}: telemetry was not enabled")
    for k in REQUIRED_KEYS:
        if not isinstance(tel.get(k), dict):
            errors.append(f"{path}: telemetry missing {k!r}")
    if rec.get("benchmark") == "load_sweep":
        errors.extend(_check_frontend(path, rec))
    if rec.get("benchmark") == "decode_throughput":
        errors.extend(_check_paged(path, rec))
    if rec.get("benchmark") in CELL_AUDIT_BENCHMARKS:
        errors.extend(_check_cell_audit(path, rec))
    return errors


def check_file(path: str, schema_version: int) -> list[str]:
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable ({e})"]
    return check_record(path, rec, schema_version)


def main(argv: list[str]) -> int:
    if not argv:
        print("usage: python -m repro_torch.benchmarks.check_schema "
              "BENCH_*.json", file=sys.stderr)
        return 2
    from repro_torch import obs

    errors = []
    for path in argv:
        errors.extend(check_file(path, obs.SCHEMA_VERSION))
    for e in errors:
        print(f"[bench-schema] FAIL {e}", file=sys.stderr)
    if not errors:
        print(
            f"[bench-schema] {len(argv)} record(s) OK "
            f"(telemetry schema v{obs.SCHEMA_VERSION})"
        )
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

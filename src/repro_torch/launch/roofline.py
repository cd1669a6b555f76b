"""Roofline report: render the tables from dry-run JSONs (port of
`repro.launch.roofline`).

Reads experiments/dryrun_torch/<mesh>/<arch>__<shape>.json (written by
`launch.dryrun`; the reference's own records read the same) and emits:
  * the per-cell three-term table (compute / memory / collective seconds,
    dominant term, MODEL_FLOPS/HLO_FLOPs, roofline fraction),
  * per-cell one-line improvement notes (rule-based on the dominant term),
  * a machine-readable summary JSON for the §Perf hillclimb loop.

Imports nothing but the standard library — runs anywhere, any time
after a dry-run. The terms are modelled at the H100's data-sheet figures
(`launch.op_analysis`), not measured.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional


_SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load_records(
    out_dir: str, mesh: str, *, include_variants: bool = False
) -> list[dict]:
    recs = []
    for fn in sorted(glob.glob(os.path.join(out_dir, mesh, "*.json"))):
        stem = os.path.basename(fn)[: -len(".json")]
        is_baseline = any(
            stem.endswith("__" + s) for s in _SHAPE_NAMES
        )
        if not include_variants and not is_baseline:
            continue  # tagged hillclimb variants live in §Perf
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


def improvement_note(rec: dict) -> str:
    r = rec["roofline"]
    dom = r["dominant"]
    useful = r["useful_flops_ratio"]
    if dom == "compute":
        if useful < 0.5:
            return (
                "compute-bound with low useful ratio: cut masked/padded "
                "FLOPs (causal block-skip, tighter head/vocab padding)"
            )
        return "compute-bound: already near useful peak; overlap collectives"
    if dom == "memory":
        if rec["kind"] == "decode":
            return (
                "memory-bound decode: weight bytes dominate -> SPE "
                "quant+sparse storage (the paper's technique) cuts HBM "
                "traffic ~2-8x"
            )
        return (
            "memory-bound: raise arithmetic intensity (fusion, larger "
            "microbatch, bf16 master weights or opt-state offload)"
        )
    return (
        "collective-bound: reshard to cut all-gathers (FSDP->TP shift), "
        "overlap via latency-hiding scheduler, or compress grads"
    )


def fmt_seconds(s: float) -> str:
    if s >= 1.0:
        return f"{s:7.2f}s "
    if s >= 1e-3:
        return f"{s * 1e3:7.2f}ms"
    return f"{s * 1e6:7.1f}us"


def render_table(recs: list[dict]) -> str:
    hdr = (
        "| arch | shape | t_compute | t_memory | t_collective | dominant "
        "| mem/dev GiB (h100-adj) | MODEL/HLO flops | roofline frac |\n"
        "|---|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    for r in recs:
        rf = r["roofline"]
        mem = r["memory"]["total_per_device_bytes"]
        adj = mem - r["memory"].get("bf16_emulation_bytes", 0)
        rows.append(
            f"| {r['arch']} | {r['shape']} |"
            f" {fmt_seconds(rf['t_compute_s'])} |"
            f" {fmt_seconds(rf['t_memory_s'])} |"
            f" {fmt_seconds(rf['t_collective_s'])} |"
            f" **{rf['dominant']}** |"
            f" {mem / 2**30:.2f} ({adj / 2**30:.2f}) |"
            f" {rf['useful_flops_ratio']:.3f} |"
            f" {rf['roofline_fraction']:.3f} |"
        )
    return hdr + "\n".join(rows) + "\n"


def render_notes(recs: list[dict]) -> str:
    out = []
    for r in recs:
        out.append(
            f"- **{r['arch']} x {r['shape']}** ({r['roofline']['dominant']}"
            f"-bound): {improvement_note(r)}"
        )
    return "\n".join(out) + "\n"


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="singlepod_16x16")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    recs = load_records(args.dir, args.mesh)
    if not recs:
        print(f"no records under {args.dir}/{args.mesh}")
        return
    print(render_table(recs))
    print(render_notes(recs))
    # summary for the hillclimb loop
    worst = min(recs, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(recs, key=lambda r: r["roofline"]["t_collective_s"])
    print("\nhillclimb candidates:")
    print(f"  worst roofline fraction : {worst['arch']} x {worst['shape']}"
          f" ({worst['roofline']['roofline_fraction']:.3f})")
    print(f"  most collective-bound   : {coll['arch']} x {coll['shape']}"
          f" ({coll['roofline']['t_collective_s']:.4f}s)")


if __name__ == "__main__":
    main()

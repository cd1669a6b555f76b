"""Fleet streaming throughput on one card: patients sustained at 250 Hz
vs batch bucket size.

Port of `benchmarks/stream_throughput.py` on one device. Two throughput
views per bucket cell:

  * wall — what this host and its card actually sustain through the full
    loop (schedule → pack → inference on the card → vectorized vote);
  * modeled chip fleet — the perf model's chip twin running every bucket
    serially at its per-segment latency (35 µs at the paper's operating
    point). That is the modelled ASIC's number, not the card's.

`--smoke` runs the acceptance configuration: a 1000-patient fleet that
must sustain real-time rate (one 512-sample segment per patient per
2.048 s => ~488 seg/s aggregate) with zero scheduler drops, plus a
reduced sweep, and checks both criteria, the telemetry schema, and the
< 3% overhead of enabled telemetry on the fleet loop's wall (where the
host can resolve it).

The record carries a `telemetry` section in the shared
`obs.telemetry_section` schema plus an `overhead` sub-record. It is
printed, and written only where `--out` says: never to the repository's
BENCH_stream.json, which holds the JAX package's runs.

    python -m repro_torch.benchmarks.stream_throughput [--smoke] [--out PATH]

`run(device="cpu")` runs it on the CPU; `device=None` means the CUDA
card and raises without one.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json

import torch

from repro_torch import _device, obs
from repro_torch.core import compiler, vadetect
from repro_torch.stream import (
    SEGMENT_PERIOD_S,
    FleetConfig,
    FleetRunner,
    simulate,
)


def run_cell(
    program,
    *,
    patients: int,
    segments: int,
    bucket: int,
    seed: int = 0,
    device: _device.DeviceLike = None,
) -> dict:
    """One bucket cell: fleet sim with a single-bucket ladder (plus a
    small partial-batch bucket so drains stay fixed-shape)."""
    runner = FleetRunner(program, path="twin", device=device)
    small = max(8, bucket // 16)
    buckets = (small, bucket) if small < bucket else (bucket,)
    cfg = FleetConfig(
        n_patients=patients,
        segments_per_patient=segments,
        seed=seed,
        va_fraction=0.05,
        jitter_frac=0.02,
        buckets=buckets,
        path="twin",
    )
    out = simulate(cfg, runner=runner)
    m = out["metrics"]
    return {
        "bucket": bucket,
        "patients": patients,
        "segments_total": m["segments_total"],
        "dropped_total": m["dropped_total"],
        "pad_fraction": m["pad_fraction"],
        "jit_cache_misses": out["jit_cache_misses"],
        "wall_segments_per_s": m["segments_per_s_wall"],
        "modeled_chip_segments_per_s": out["chip"][
            "modeled_fleet_segments_per_s"
        ],
        "deadline_slack_s": m.get("deadline_slack_s"),
        "patients_sustained_at_250hz_wall": int(
            m["segments_per_s_wall"] * SEGMENT_PERIOD_S
        ),
        "patients_sustained_at_250hz_modeled_chips": int(
            out["chip"]["modeled_fleet_segments_per_s"]
            * SEGMENT_PERIOD_S
        ),
    }


def wall_floor(walls: list[float]) -> float:
    """The mean of the fastest sixth of `walls` (at least 3 of them):
    the noise floor of a loop's wall. The min alone hangs on one run's
    luck: in one H100 run the two disabled arms' mins were 2.2% apart,
    their floors 0.4%."""
    k = min(len(walls), max(3, len(walls) // 6))
    return sum(sorted(walls)[:k]) / k


def measure_overhead(
    program, *, patients: int = 128, segments: int = 5, reps: int = 24,
    max_reps: int = 72, device: _device.DeviceLike = None,
) -> dict:
    """Measured (not assumed) telemetry tax on the fleet loop: the same
    fleet config on one shared pre-warmed runner, simulated in three
    arms — telemetry disabled, enabled, disabled again — in all six
    orders in turn, each arm's wall read as its floor (`wall_floor`: OS
    scheduling and GC only ever add time). GC is paused during the timed
    regions for the same reason.

    The wall is the loop's own (`metrics.wall_s`: schedule, pack,
    classify, vote), where every emission happens. The reference times
    whole `simulate` calls; here each call also prepares its segments and
    warms its buckets first, outside the loop and untouched by telemetry,
    which would dilute the ratio.

    Resolution: the two disabled arms are an A/A control, so how far
    their floors disagree (`noise_spread`) is how finely this host
    resolves the ratio. Rounds of `reps` are added, up to `max_reps`,
    until it is within 1%, a third of the 3% budget, and the ratio is
    farther from 1.03 than that; the ratio is `resolvable` where the
    floors are within 1%. (The reference's criterion, the disabled walls'
    median over their min, measures the host's spread, not the floor's
    error: an H100 machine's host spread 4-46% over the runs of one
    loop.)"""
    cfg = FleetConfig(
        n_patients=patients,
        segments_per_patient=segments,
        va_fraction=0.05,
        jitter_frac=0.02,
        buckets=(32, 128),
        path="twin",
    )
    saved = obs.get()
    runner = FleetRunner(program, path="twin", device=device)
    arms = ("disabled", "enabled", "disabled_again")
    orders = list(itertools.permutations(arms))
    walls = {arm: [] for arm in arms}
    try:
        obs.reset()
        simulate(cfg, runner=runner)  # untimed: warm every bucket
        while True:
            for _ in range(reps):
                # the arms' six orders in turn: scheduling noise arrives
                # in bursts, and the run before leaves the allocator in
                # its own state (after an enabled run, its freed events),
                # so no arm may keep one place or one predecessor
                order = orders[len(walls["enabled"]) % len(orders)]
                for arm in order:
                    if arm == "enabled":
                        obs.configure(enabled=True)
                    else:
                        obs.reset()
                    gc.disable()
                    try:
                        out = simulate(cfg, runner=runner)
                    finally:
                        gc.enable()
                    walls[arm].append(out["metrics"]["wall_s"])
            noise_spread = abs(wall_floor(walls["disabled_again"])
                               / wall_floor(walls["disabled"]) - 1.0)
            dis = wall_floor(walls["disabled"] + walls["disabled_again"])
            en = wall_floor(walls["enabled"])
            # stop once the host resolves the ratio and the reading is
            # farther from the 3% line than that resolution
            if (noise_spread <= 0.01 and abs(en / dis - 1.03) > noise_spread
                    or len(walls["enabled"]) >= max_reps):
                break
    finally:
        obs.install(saved)
    return {
        "patients": patients,
        "segments": segments,
        "reps": len(walls["enabled"]),
        "disabled_wall_s": dis,
        "enabled_wall_s": en,
        "overhead_ratio": en / dis,
        "noise_spread": noise_spread,
        "resolvable": noise_spread <= 0.01,
        **{f"{arm}_walls_s": w for arm, w in walls.items()},
    }


def _require(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


def check(rec: dict) -> None:
    """The acceptance criteria that apply on one card: zero scheduler
    drops everywhere, real-time sustained for 1000 patients, the
    telemetry schema (drop counter, flush-latency percentiles, classify
    cells seen, device memory on a card), and the < 3% enabled-telemetry
    tax on the loop's wall where the host can resolve it."""
    cells, realtime, t = rec["cells"], rec["realtime_1000_patients"], rec["telemetry"]
    _require(all(c["dropped_total"] == 0 for c in cells), cells)
    _require(realtime["dropped_total"] == 0, realtime)
    _require(realtime["realtime_factor"] >= 1.0, realtime)
    _require(t["schema_version"] == obs.SCHEMA_VERSION and t["enabled"], t)
    _require(t["counters"].get("stream.dropped_total") == 0, t["counters"])
    flush = t["histograms"]["stream.flush_wall_s"]
    _require(flush["count"] > 0 and None not in (
        flush["p50"], flush["p99"], flush["p999"]), flush)
    _require(any(k.startswith("stream.classify") and v
                 for k, v in t["recompiles"].items()), t["recompiles"])
    if rec["device"]["type"] == "cuda":
        _require(t["peak_device_memory_bytes"] > 0, t)
    overhead = t["overhead"]
    if overhead["resolvable"]:
        _require(overhead["overhead_ratio"] < 1.03, overhead)


def run(
    *, smoke: bool = False, patients: int = 512, segments: int = 6,
    device: _device.DeviceLike = None,
) -> dict:
    """Run the sweep, the 1000-patient real-time cell and the overhead
    measurement with telemetry enabled; check the record (`check`) and
    return it. The telemetry configured here stays installed, so a
    caller can write its trace."""
    dev = _device.resolve(device)
    # before any runner is built, so its cells register with the probe
    obs.configure(enabled=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = vadetect.init(torch.Generator().manual_seed(0), device=dev)
    program = compiler.compile_model(params)

    if smoke:
        buckets = [32, 128]
        sweep_patients, sweep_segments = 64, 4
    else:
        buckets = [32, 128, 256]
        sweep_patients, sweep_segments = patients, segments

    cells = []
    for b in buckets:
        cell = run_cell(program, patients=sweep_patients,
                        segments=sweep_segments, bucket=b, device=dev)
        cells.append(cell)
        print(
            f"[stream_throughput] bucket={b:4d} "
            f"wall={cell['wall_segments_per_s']:7.0f} seg/s "
            f"modeled-chip={cell['modeled_chip_segments_per_s']:7.0f} "
            f"seg/s dropped={cell['dropped_total']}",
            flush=True,
        )

    # the 1000-patient real-time acceptance cell
    rt_runner = FleetRunner(program, path="twin", device=dev)
    rt_cfg = FleetConfig(
        n_patients=1000,
        segments_per_patient=6,  # one full vote window per patient
        va_fraction=0.05,
        jitter_frac=0.02,
        buckets=(32, 128, 512),
        path="twin",
    )
    rt = simulate(rt_cfg, runner=rt_runner)
    realtime = {
        "patients": 1000,
        "segments_total": rt["metrics"]["segments_total"],
        "dropped_total": rt["metrics"]["dropped_total"],
        "required_segments_per_s": rt["realtime"][
            "required_segments_per_s"
        ],
        "sustained_segments_per_s": rt["realtime"][
            "sustained_segments_per_s"
        ],
        "realtime_factor": rt["realtime"]["realtime_factor"],
        "deadline_slack_s": rt["metrics"].get("deadline_slack_s"),
        "jit_cache_misses": rt["jit_cache_misses"],
    }
    print(
        f"[stream_throughput] 1000 patients: "
        f"{realtime['sustained_segments_per_s']:.0f} seg/s sustained vs "
        f"{realtime['required_segments_per_s']:.0f} required "
        f"({realtime['realtime_factor']:.1f}x real-time), "
        f"dropped={realtime['dropped_total']}"
    )

    overhead = measure_overhead(program, device=dev)
    print(
        f"[stream_throughput] telemetry overhead on the loop: enabled "
        f"{overhead['enabled_wall_s'] * 1e3:.3f} ms vs disabled "
        f"{overhead['disabled_wall_s'] * 1e3:.3f} ms "
        f"({(overhead['overhead_ratio'] - 1) * 100:+.1f}%; the disabled "
        f"arms' floors {overhead['noise_spread']:.1%} apart over "
        f"{overhead['reps']} reps)"
    )
    telemetry = obs.telemetry_section()
    telemetry["overhead"] = overhead
    rec = {
        "benchmark": "stream_throughput",
        "device": {
            "type": dev.type,
            "name": (torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else "cpu"),
        },
        "chip_latency_us": program.report.latency_s * 1e6,
        "cells": cells,
        "realtime_1000_patients": realtime,
        "telemetry": telemetry,
    }
    check(rec)
    if not overhead["resolvable"]:
        print(
            f"[stream_throughput] overhead check skipped: the disabled "
            f"arms' floors {overhead['noise_spread']:.1%} apart > 1% "
            f"(ratio {overhead['overhead_ratio']:.3f} recorded)"
        )
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sweep + 1000-patient real-time check")
    ap.add_argument("--patients", type=int, default=512)
    ap.add_argument("--segments", type=int, default=6)
    ap.add_argument("--out", default=None,
                    help="write the JSON record here (default: nowhere)")
    ap.add_argument("--trace-out", default=None, metavar="PREFIX",
                    help="write the telemetry trace to PREFIX.jsonl "
                         "(event log) + PREFIX.json (Chrome/Perfetto)")
    args = ap.parse_args()
    rec = run(smoke=args.smoke, patients=args.patients,
              segments=args.segments)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[stream_throughput] -> {args.out}")
    if args.trace_out:
        jsonl, chrome = obs.get().finish(args.trace_out)
        print(f"[obs] trace written: {jsonl} + {chrome}")


if __name__ == "__main__":
    main()

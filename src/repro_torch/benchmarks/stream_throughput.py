"""Fleet streaming throughput: patients sustained at 250 Hz vs batch
bucket size vs device count.

Port of `benchmarks/stream_throughput.py`. Two throughput views per
(bucket, devices) cell:

  * wall — what this host and its cards actually sustain through the
    full loop (schedule → pack → sharded inference → vectorized vote);
  * modeled chip fleet — each mesh device is one chip twin running its
    shard of every bucket serially at the perf model's per-segment
    latency (35 µs at the paper's operating point): N chips monitor N
    disjoint fleet slices, so it scales exactly linearly. That is the
    modelled ASIC's number, not the card's.

The device counts are the reference's (1, 2, 4, 8; 1 and 8 with
`--smoke`) that the process group holds: one rank a device
(`--devices N` brings N ranks up through `launch._spawn.run`; one card
runs 1). A cell of d devices runs on a data mesh over the first d ranks
(`launch.mesh.make_data_mesh`); `_verify_batch_sharding` checks that
every rank of it really classifies bucket/d rows. Every rank runs the
sweep; rank 0 runs the 1000-patient cell's report, the overhead
measurement and the checks, and returns the record.

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
import statistics

import torch
import torch.distributed as dist

from repro_torch import _device, obs
from repro_torch.core import compiler, vadetect
from repro_torch.launch import _spawn
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.stream import (
    SEGMENT_PERIOD_S,
    FleetConfig,
    FleetRunner,
    simulate,
)


def _verify_batch_sharding(runner, bucket: int, devices: int) -> bool:
    """The modelled chip-fleet rate is N/latency *by definition*; what
    must be verified is the mechanism behind it — that every rank of the
    runner's mesh really classifies bucket/N rows of a bucket (a
    collective over the mesh: each of its ranks calls it)."""
    if devices <= 1:
        return True
    rows = runner.local_rows(
        torch.zeros((bucket, vadetect.RECORD_LEN), device=runner.device))
    counts = torch.zeros(devices, dtype=torch.int64, device=runner.device)
    counts[runner.mesh.get_local_rank()] = rows.shape[0]
    dist.all_reduce(counts, group=runner.mesh.get_group())
    return (runner.n_devices == devices
            and set(counts.tolist()) == {bucket // devices})


def run_cell(
    program,
    *,
    patients: int,
    segments: int,
    bucket: int,
    devices: int = 1,
    seed: int = 0,
    device: _device.DeviceLike = None,
) -> dict | None:
    """One (bucket, devices) cell: fleet sim with a single-bucket ladder
    (plus a small partial-batch bucket so drains stay fixed-shape), on a
    data mesh over the first `devices` ranks. Every rank of the group
    calls it; a rank outside the mesh returns None (at one device, every
    rank but 0)."""
    mesh = make_data_mesh(devices, device)
    if (mesh.get_coordinate() is None if mesh is not None
            else _spawn.rank() != 0):
        return None
    runner = FleetRunner(program, path="twin", device=device, mesh=mesh)
    shard_ok = _verify_batch_sharding(runner, bucket, devices)
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
        "devices": devices,
        "batch_sharded_over_devices": shard_ok,
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
    the noise floor of a loop's wall, reported beside the ratio."""
    k = min(len(walls), max(3, len(walls) // 6))
    return sum(sorted(walls)[:k]) / k


def median_bounds(xs: list[float], z: float = 2.576) -> tuple[float, float]:
    """A distribution-free ~99% interval for the median of `xs`: the
    order statistics k and n - 1 - k, k = (n - z·sqrt(n)) / 2."""
    s = sorted(xs)
    k = max(0, int((len(s) - z * len(s) ** 0.5) / 2))
    return s[k], s[len(s) - 1 - k]


def measure_overhead(
    program, *, patients: int = 128, segments: int = 5, reps: int = 24,
    max_reps: int = 96, device: _device.DeviceLike = None,
) -> dict:
    """Measured (not assumed) telemetry tax on the fleet loop: the same
    fleet config on one shared pre-warmed runner, simulated in three
    arms — telemetry disabled, enabled, disabled again — back to back in
    each repetition, the repetitions taking the arms' six orders in
    turn. GC is paused during the timed regions.

    The wall is the loop's own (`metrics.wall_s`: schedule, pack,
    classify, vote), where every emission happens. The reference times
    whole `simulate` calls; here each call also prepares its segments and
    warms its buckets first, outside the loop and untouched by telemetry,
    which would dilute the ratio.

    The ratio is paired: the median over repetitions of the enabled wall
    over the mean of the same repetition's two disabled walls. The
    loop's wall follows the shared host's speed, which drifts by up to
    half between repetitions on an H100 machine; the three runs of one
    repetition share that speed, where each arm's own floor (the mean of
    its fastest sixth, the estimator this replaced) reads whichever fast
    spells its runs caught. Resolution: the two disabled arms are an A/A
    control, the median of their paired ratio; rounds of `reps` are
    added, up to `max_reps`, until it is within 1% of 1, a third of the
    3% budget, and the ratio's ~99% interval (`median_bounds`) lies on
    one side of 1.03. The ratio is `resolvable` where the A/A control
    is within 1%."""
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
                # the arms' six orders in turn: the run before leaves the
                # allocator in its own state (after an enabled run, its
                # freed events), so no arm may keep one place or one
                # predecessor
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
            ratios = [e / ((d + a) / 2) for d, e, a in zip(
                walls["disabled"], walls["enabled"], walls["disabled_again"])]
            control = statistics.median(
                a / d for d, a in zip(walls["disabled"],
                                      walls["disabled_again"]))
            noise_spread = abs(control - 1.0)
            ratio = statistics.median(ratios)
            lo, hi = median_bounds(ratios)
            # stop once the host resolves the ratio and its interval
            # lies on one side of the 3% line
            if (noise_spread <= 0.01 and not lo < 1.03 <= hi
                    or len(walls["enabled"]) >= max_reps):
                break
    finally:
        obs.install(saved)
    dis = wall_floor(walls["disabled"] + walls["disabled_again"])
    en = wall_floor(walls["enabled"])
    return {
        "patients": patients,
        "segments": segments,
        "reps": len(walls["enabled"]),
        "disabled_wall_s": dis,
        "enabled_wall_s": en,
        "overhead_ratio": ratio,
        "ratio_bounds": [lo, hi],
        "floor_ratio": en / dis,
        "noise_spread": noise_spread,
        "resolvable": noise_spread <= 0.01,
        **{f"{arm}_walls_s": w for arm, w in walls.items()},
    }


def _require(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


def check(rec: dict) -> None:
    """The acceptance criteria: zero scheduler drops everywhere, every
    multi-device cell's buckets split bucket/N over its ranks, the
    modelled speedup past 4 where the sweep spans 8x the devices,
    real-time sustained for 1000 patients, the telemetry schema (drop
    counter, flush-latency percentiles, classify cells seen, device
    memory on a card), and the < 3% enabled-telemetry tax on the loop's
    wall where the host can resolve it."""
    cells, realtime, t = rec["cells"], rec["realtime_1000_patients"], rec["telemetry"]
    scaling = rec["scaling_largest_bucket"]
    _require(all(c["dropped_total"] == 0 for c in cells), cells)
    _require(all(c["batch_sharded_over_devices"] for c in cells), cells)
    if scaling["devices_hi"] >= 8 * scaling["devices_lo"]:
        _require(scaling["modeled_speedup"] > 4.0, scaling)
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


def device_counts(smoke: bool) -> list[int]:
    """The reference's device counts that the process group holds."""
    counts = [1, 8] if smoke else [1, 2, 4, 8]
    return [d for d in counts if d <= _spawn.world_size()]


def sweep(program, buckets, counts, *, patients: int, segments: int,
          device: _device.DeviceLike = None) -> tuple[list, dict]:
    """Every (bucket, devices) cell and the device-count scaling record
    on the largest bucket (the modelled chip fleet's; the wall numbers
    are reported beside it). Every rank calls it; rank 0 gets every cell
    and the scaling record, the others their own cells and None."""
    cells = []
    for b in buckets:
        for d in counts:
            cell = run_cell(program, patients=patients, segments=segments,
                            bucket=b, devices=d, device=device)
            if cell is None:
                continue
            cells.append(cell)
            if _spawn.rank() == 0:
                print(
                    f"[stream_throughput] bucket={b:4d} devices={d} "
                    f"wall={cell['wall_segments_per_s']:7.0f} seg/s "
                    f"modeled-chips="
                    f"{cell['modeled_chip_segments_per_s']:7.0f} "
                    f"seg/s dropped={cell['dropped_total']}",
                    flush=True,
                )
    if _spawn.rank() != 0:
        return cells, None
    largest = max(buckets)
    by_dev = {c["devices"]: c for c in cells if c["bucket"] == largest}
    lo, hi = min(by_dev), max(by_dev)
    scaling = {
        "bucket": largest,
        "devices_lo": lo,
        "devices_hi": hi,
        "modeled_chip_segments_per_s_lo": by_dev[lo][
            "modeled_chip_segments_per_s"],
        "modeled_chip_segments_per_s_hi": by_dev[hi][
            "modeled_chip_segments_per_s"],
        "modeled_speedup": by_dev[hi]["modeled_chip_segments_per_s"]
        / by_dev[lo]["modeled_chip_segments_per_s"],
        "wall_segments_per_s_lo": by_dev[lo]["wall_segments_per_s"],
        "wall_segments_per_s_hi": by_dev[hi]["wall_segments_per_s"],
    }
    return cells, scaling


def run(
    *, smoke: bool = False, patients: int = 512, segments: int = 6,
    device: _device.DeviceLike = None,
) -> dict | None:
    """Run the sweep, the 1000-patient real-time cell and the overhead
    measurement with telemetry enabled; check the record (`check`) and
    return it (None on ranks other than 0, which run the sweep and the
    real-time cell only). The telemetry configured here stays installed,
    so a caller can write its trace."""
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
    counts = device_counts(smoke)
    cells, scaling = sweep(program, buckets, counts, patients=sweep_patients,
                           segments=sweep_segments, device=dev)

    # the 1000-patient real-time acceptance cell, on the most devices
    rt_devices = max(counts)
    rt_mesh = make_data_mesh(rt_devices, dev)
    if (rt_mesh.get_coordinate() is None if rt_mesh is not None
            else _spawn.rank() != 0):
        return None
    rt_runner = FleetRunner(program, path="twin", device=dev, mesh=rt_mesh)
    rt_cfg = FleetConfig(
        n_patients=1000,
        segments_per_patient=6,  # one full vote window per patient
        va_fraction=0.05,
        jitter_frac=0.02,
        buckets=(32, 128, 512),
        path="twin",
    )
    rt = simulate(rt_cfg, runner=rt_runner)
    if _spawn.rank() != 0:
        return None
    realtime = {
        "patients": 1000,
        "devices": rt_devices,
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
        f"[stream_throughput] 1000 patients on {rt_devices} devices: "
        f"{realtime['sustained_segments_per_s']:.0f} seg/s sustained vs "
        f"{realtime['required_segments_per_s']:.0f} required "
        f"({realtime['realtime_factor']:.1f}x real-time), "
        f"dropped={realtime['dropped_total']}"
    )

    overhead = measure_overhead(program, device=dev)
    print(
        f"[stream_throughput] telemetry overhead on the loop: "
        f"{(overhead['overhead_ratio'] - 1) * 100:+.1f}% (median of "
        f"{overhead['reps']} paired reps; floors: enabled "
        f"{overhead['enabled_wall_s'] * 1e3:.3f} ms vs disabled "
        f"{overhead['disabled_wall_s'] * 1e3:.3f} ms; the A/A control "
        f"{overhead['noise_spread']:.1%} off)"
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
        "n_ranks": _spawn.world_size(),
        "chip_latency_us": program.report.latency_s * 1e6,
        "cells": cells,
        "scaling_largest_bucket": scaling,
        "realtime_1000_patients": realtime,
        "telemetry": telemetry,
    }
    check(rec)
    if not overhead["resolvable"]:
        print(
            f"[stream_throughput] overhead check skipped: the A/A "
            f"control {overhead['noise_spread']:.1%} off > 1% "
            f"(ratio {overhead['overhead_ratio']:.3f} recorded)"
        )
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sweep + 1000-patient real-time check")
    ap.add_argument("--patients", type=int, default=512)
    ap.add_argument("--segments", type=int, default=6)
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks to bring up, one a card")
    ap.add_argument("--out", default=None,
                    help="write the JSON record here (default: nowhere)")
    ap.add_argument("--trace-out", default=None, metavar="PREFIX",
                    help="write the telemetry trace to PREFIX.jsonl "
                         "(event log) + PREFIX.json (Chrome/Perfetto)")
    args = ap.parse_args()
    kw = dict(smoke=args.smoke, patients=args.patients,
              segments=args.segments)
    rec = (run(**kw) if args.devices == 1
           else _spawn.run(run, args.devices, device="cuda", kwargs=kw))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[stream_throughput] -> {args.out}")
    if args.trace_out:
        jsonl, chrome = obs.get().finish(args.trace_out)
        print(f"[obs] trace written: {jsonl} + {chrome}")


if __name__ == "__main__":
    main()

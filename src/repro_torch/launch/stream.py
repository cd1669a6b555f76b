"""Fleet streaming driver: continuous multi-patient VA monitoring on the
card (port of `repro.launch.stream`).

    python -m repro_torch.launch.stream --patients 256 --segments 8 \\
        --buckets 8,32,128,256 [--path kernel] [--json] [--trace-out P]

Draws random VA weights from `--seed` (the point is the serving path),
compiles the accelerator program, and drives the `stream` fleet
simulation: virtual-time arrivals with jitter/dropout, deadline-aware
micro-batching with urgent-patient preemption, bucketed inference
(`--path kernel` runs the hand-written `nm_spmm`), vectorized 6-segment
voting. Prints the fleet metrics summary.

The serving frontend's stream side (`serve.frontend`): `--listen
HOST:PORT` accepts patient segments over the socket transport (ROUTINE
segments defer, never drop, past `--stream-rate`; URGENT always pass) and
prints the bound address, serving until SIGINT; `--connect HOST:PORT`
offers `--patients` x `--segments` segments at `--offered-rate` seg/s
(the first `--urgent-fraction` of patients URGENT), then drains.

    python -m repro_torch.launch.stream --listen 127.0.0.1:0 --path kernel
    python -m repro_torch.launch.stream --connect HOST:PORT \\
        --patients 256 --segments 8 --offered-rate 2000

`--devices N` splits every bucket over N ranks of a ("data",) mesh
(`make_data_mesh`; `launch._spawn.run` spawns gloo ranks with
`device="cpu"`, one NCCL rank a card on the card): each rank classifies
its bucket/N rows and all-gathers the predictions. In the simulation
every rank runs the same scheduler and vote, and rank 0 reports; behind
`--listen`, rank 0 owns the socket, the scheduler and the vote, and the
other ranks replay its driver's records, classifying their rows of each
flushed bucket (`serve.frontend.Frontend.follow`); SIGINT to the
launcher stops every rank.

    python -m repro_torch.launch.stream --devices 4 --patients 256
    python -m repro_torch.launch.stream --listen 127.0.0.1:0 --devices 4

The open-loop offered-load sweep (`obs.loadlab.sweep_stream`, virtual
time): `--load-sweep` offers per-patient Poisson (or trace-driven,
`--arrival-process`) segment arrivals at `--load-fractions` of the
modelled fleet capacity over a horizon of `--segments-at-capacity`
segments at 1.0x, pins the first `--urgent-fraction` of patients URGENT,
and reports latency from intended arrival, the knee, the URGENT cohort's
deadline-slack SLO and the overload verdict (`--json` prints the
record). Latency is modelled, so the record is exactly reproducible on
any host and any `--path`; `--path kernel` classifies every flushed
bucket through `nm_spmm`. With `--devices N` every rank of the data mesh
runs the sweep (each bucket's modelled service is that of N chip twins)
and rank 0 returns the record.

    python -m repro_torch.launch.stream --load-sweep --path kernel [--json]

`main(argv, device="cpu")` runs the same paths on the CPU; with no
`device` it needs a card.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from repro_torch import _device, obs
from repro_torch.core import compiler, vadetect
from repro_torch.launch import _spawn
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.stream import FleetConfig, FleetRunner, simulate

__all__ = ["main", "make_data_mesh", "stream_connect", "stream_listen",
           "stream_load_sweep"]


def stream_load_sweep(args, device) -> Optional[dict]:
    """Open-loop offered-load sweep in virtual time on this rank (over a
    data mesh of `--devices` ranks when that is more than one; every rank
    calls it): per-patient Poisson/trace segment arrivals at fractions of
    the modeled fleet capacity, latency from intended arrival, knee
    location, pinned URGENT-cohort deadline-slack SLO, overload verdict
    (see `obs.loadlab`). Exactly reproducible on any host. Rank 0 prints
    and returns the record, the others None."""
    from repro_torch.obs import loadlab

    dev = _device.resolve(device)
    if args.trace_out and not obs.get().enabled:  # a spawned rank
        obs.configure(enabled=True)
    buckets = _buckets(args)
    mesh = make_data_mesh(args.devices, dev)
    runner = FleetRunner(_program(args, dev), path=args.path, device=dev,
                         mesh=mesh)
    out = loadlab.sweep_stream(
        n_patients=args.patients,
        buckets=buckets,
        load_fractions=tuple(float(f)
                             for f in args.load_fractions.split(",")),
        segments_at_capacity=args.segments_at_capacity,
        seed=args.seed,
        urgent_fraction=args.urgent_fraction,
        process=args.arrival_process,
        runner=runner,
    )
    if _spawn.rank() != 0:
        return None
    if args.trace_out:
        jsonl, chrome = obs.get().finish(args.trace_out)
        print(f"[obs] trace written: {jsonl} + {chrome}")
    if args.json:
        print(json.dumps(out, indent=1, default=float))
        return out
    print(
        f"[stream] open-loop sweep: {args.patients} patients, "
        f"buckets={list(buckets)}, capacity "
        f"{out['capacity_segments_per_s']:.0f} seg/s, "
        f"{args.arrival_process} arrivals"
    )
    for p in out["points"]:
        print(
            f"[stream]   {p['load_fraction']:>5.2f}x  "
            f"offered {p['offered_load']:9.0f}/s  "
            f"p50 {p['p50_s'] * 1e3:7.2f}ms  "
            f"p99 {p['p99_s'] * 1e3:7.2f}ms  "
            f"p99.9 {p['p999_s'] * 1e3:7.2f}ms  "
            f"dropped={p['dropped']}"
        )
    k = out["knee"]
    if k.get("detected"):
        print(
            f"[stream] saturation knee @ {k['knee_rate']:.0f} seg/s "
            f"(p99 grows {k['post_knee_growth']:.1f}x past it)"
        )
    print(
        f"[stream] URGENT cohort ({out['urgent_patients']} patients) "
        f"overload burn rate "
        f"{out['slo']['urgent_overload'].get('burn_rate'):.2f}; "
        f"verdict = {out['overload']['verdict']}"
    )
    return out


def stream_listen(args, program, buckets, device, *, mesh=None,
                  records=None) -> Optional[dict]:
    """Accept patient segments over the serving frontend's socket
    transport until SIGINT. Returns the frontend's stats; raises when its
    driver thread died. With a data `mesh` and `records` (every rank of
    the mesh calls it), rank 0 serves and the other ranks follow its
    records, returning None."""
    from repro_torch.launch.serve import follow, serve_frontend
    from repro_torch.serve.frontend import Frontend, FrontendConfig

    lead = _spawn.rank() == 0
    runner = FleetRunner(program, path=args.path, device=device, mesh=mesh)
    fe = Frontend(
        n_patients=args.patients,
        runner=runner,
        cfg=FrontendConfig(
            stream_rate_rps=args.stream_rate,
            stream_buckets=buckets,
            stream_max_wait_s=args.max_wait,
        ),
        records=records if lead else None,
    )
    fe.warm()
    if not lead:
        follow(fe, records)
        return None
    serve_frontend(fe, args.listen, "stream",
                   f"{args.patients} patients, routine rate: "
                   f"{args.stream_rate or 'unbounded'}, devices "
                   f"{runner.n_devices}", leads_ranks=records is not None)
    return {"stats": fe.stats()}


def _listen_rank(args, device):
    """`--listen --devices N` on this rank of the data mesh: the program,
    the mesh and the record group on every rank, then `stream_listen`."""
    from repro_torch.serve.frontend import RankRecords

    dev = _device.resolve(device)
    mesh = make_data_mesh(args.devices, dev)
    records = RankRecords(_spawn.TIMEOUT_S)
    return stream_listen(args, _program(args, dev), _buckets(args), dev,
                         mesh=mesh, records=records)


def stream_connect(args) -> dict:
    """Open-loop socket client: offer --patients x --segments patient
    segments at --offered-rate seg/s (the first --urgent-fraction of
    patients URGENT), then drain and report the ack ledger."""
    import asyncio

    from repro_torch.launch.serve import _hostport
    from repro_torch.obs import loadlab
    from repro_torch.serve.frontend import SocketClient

    host, port = _hostport(args.connect)
    n_urgent = max(1, int(round(args.urgent_fraction * args.patients)))
    total = args.patients * args.segments
    intended = loadlab.arrival_times(
        args.seed, 0, rate_hz=args.offered_rate, n=total,
        process=args.arrival_process,
    )

    async def amain():
        client = await SocketClient.connect(host, port)
        futs = []
        t0 = time.perf_counter()
        for i in range(total):
            delay = intended[i] - (time.perf_counter() - t0)
            if delay > 0:
                await asyncio.sleep(delay)
            p, s = i % args.patients, i // args.patients
            futs.append(await client.send_segment(
                patient=p, seq=s, urgent=p < n_urgent
            ))
        acks = [await asyncio.wait_for(f, 60.0) for f in futs]
        stats = (await client.drain()).get("stats", {})
        await client.close()
        return acks, stats, time.perf_counter() - t0

    acks, stats, wall = asyncio.run(amain())
    by: dict = {}
    for a in acks:
        by[a["status"]] = by.get(a["status"], 0) + 1
    print(f"[stream] {total} segments offered at "
          f"{args.offered_rate:.1f}/s ({n_urgent} urgent patients): "
          f"acks {by}")
    enq = stats.get("sched_enqueued_total", 0)
    packed = stats.get("sched_packed_total", 0)
    print(f"[stream] drained: enqueued={enq} packed={packed} "
          f"left-behind={enq - packed} "
          f"deferred={stats.get('seg_deferred', 0)}")
    return {"offered": total, "urgent_patients": n_urgent, "acks": by,
            "acked": len(acks), "stats": stats, "wall_s": wall}


def main(
    argv: Optional[Sequence[str]] = None, device: _device.DeviceLike = None
) -> dict:
    """Parse `argv` and run; returns the run's record. `device=None` means
    the CUDA card (raises without one)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--patients", type=int, default=256)
    ap.add_argument("--segments", type=int, default=8,
                    help="segments per patient over the horizon")
    ap.add_argument("--buckets", default="8,32,128,256")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--path", default="twin",
                    choices=["twin", "reference", "kernel", "dense"])
    ap.add_argument("--va-fraction", type=float, default=0.05)
    ap.add_argument("--jitter", type=float, default=0.05,
                    help="arrival jitter std as a fraction of 2.048s")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-segment telemetry-gap probability")
    ap.add_argument("--max-wait", type=float, default=0.256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--load-sweep", action="store_true",
                    help="run the open-loop offered-load sweep "
                         "(repro_torch.obs.loadlab, virtual time) instead "
                         "of the periodic-arrival simulation")
    ap.add_argument("--load-fractions",
                    default="0.25,0.5,0.75,1.0,1.5,2.0",
                    help="offered load as fractions of the modeled "
                         "capacity (comma-separated)")
    ap.add_argument("--segments-at-capacity", type=int, default=1024,
                    help="virtual horizon, expressed as segments "
                         "offered by the 1.0x point")
    ap.add_argument("--urgent-fraction", type=float, default=0.125,
                    help="pinned URGENT cohort fraction for the "
                         "class-survival SLO (with --connect: the URGENT "
                         "patients' fraction)")
    ap.add_argument("--arrival-process", default="poisson",
                    choices=["poisson", "trace"],
                    help="interarrival process for --load-sweep and "
                         "--connect")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="accept patient segments over the serving "
                         "frontend's socket transport")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="open-loop socket client against a --listen "
                         "frontend (sends patients x segments at "
                         "--offered-rate)")
    ap.add_argument("--offered-rate", type=float, default=100.0,
                    help="with --connect: offered load in segments/s")
    ap.add_argument("--stream-rate", type=float, default=None,
                    help="with --listen: ROUTINE admission rate in "
                         "segments/s (past it segments defer, never "
                         "drop; default unbounded)")
    ap.add_argument("--json", action="store_true",
                    help="dump the full result record as JSON")
    ap.add_argument("--trace-out", default=None, metavar="PREFIX",
                    help="enable telemetry; on exit write PREFIX.jsonl "
                         "(event log) and PREFIX.json (Chrome/Perfetto "
                         "trace)")
    args = ap.parse_args(argv)
    dev = _device.resolve(device)
    if args.trace_out:
        # before the runner is built, so its cells register with the probe
        obs.configure(enabled=True)

    if args.connect:
        return stream_connect(args)
    sweep = args.load_sweep and not args.listen
    if args.devices > 1:
        return _spawn.run(
            _listen_rank if args.listen
            else stream_load_sweep if sweep else _simulate_main,
            args.devices,
            device=dev.type,
            args=(args, dev.type if dev.type == "cpu" else None),
            until_stopped=bool(args.listen),
        )
    if args.listen:
        return stream_listen(args, _program(args, dev), _buckets(args), dev)
    if sweep:
        return stream_load_sweep(args, dev)
    return _simulate_main(args, dev)


def _buckets(args) -> tuple:
    return tuple(sorted(int(b) for b in args.buckets.split(",")))


def _program(args, dev):
    params = vadetect.init(torch.Generator().manual_seed(args.seed),
                           device=dev)
    return compiler.compile_model(params)


def _simulate_main(args, device):
    """The fleet simulation on this rank (over a data mesh of
    `--devices` ranks when that is more than one); rank 0 prints and
    returns the record."""
    dev = _device.resolve(device)
    if args.trace_out and not obs.get().enabled:  # a spawned rank
        obs.configure(enabled=True)
    buckets = _buckets(args)
    mesh = make_data_mesh(args.devices, dev)
    lead = _spawn.rank() == 0
    cfg = FleetConfig(
        n_patients=args.patients,
        segments_per_patient=args.segments,
        seed=args.seed,
        va_fraction=args.va_fraction,
        jitter_frac=args.jitter,
        dropout=args.dropout,
        buckets=buckets,
        max_wait_s=args.max_wait,
        path=args.path,
    )
    out = simulate(cfg, _program(args, dev), device=dev, mesh=mesh)
    if not lead:
        return None
    if args.trace_out:
        out["telemetry"] = obs.telemetry_section()
        jsonl, chrome = obs.get().finish(args.trace_out)
        print(f"[obs] trace written: {jsonl} + {chrome}")
    if args.json:
        print(json.dumps(out, indent=1, default=str))
        return out
    m, rt, chip = out["metrics"], out["realtime"], out["chip"]
    print(
        f"[stream] {args.patients} patients x {args.segments} segments, "
        f"buckets={list(buckets)}, devices={out['config']['n_devices']}, "
        f"path={args.path}"
    )
    print(
        f"[stream] segments={m['segments_total']} "
        f"batches={m['batches_total']} pad={m['pad_fraction']:.1%} "
        f"dropped={m['dropped_total']} "
        f"jit_cache_misses={out['jit_cache_misses']}"
    )
    print(
        f"[stream] wall {m['segments_per_s_wall']:.0f} seg/s "
        f"({rt['realtime_factor']:.1f}x the "
        f"{rt['required_segments_per_s']:.0f} seg/s real-time "
        f"requirement); modeled chip fleet "
        f"{chip['modeled_fleet_segments_per_s']:.0f} seg/s"
    )
    if "deadline_slack_s" in m:
        sl = m["deadline_slack_s"]
        print(
            f"[stream] deadline slack p50={sl['p50']*1e3:.1f}ms "
            f"worst-1%={sl['worst_1pct']*1e3:.1f}ms "
            f"violations={sl['violations']}"
        )
    print(
        f"[stream] diagnoses={m['diagnoses_total']} "
        f"(VA={m['va_diagnoses_total']}) urgent-packed="
        f"{m['urgent_packed_total']} chip/segment="
        f"{chip['latency_us_per_segment']:.1f}us"
    )
    return out


if __name__ == "__main__":
    main()

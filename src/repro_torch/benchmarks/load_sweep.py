"""Open-loop load lab: tail-latency-vs-offered-load, knees, SLO burn.

Port of `benchmarks/load_sweep.py`. Drives both request paths through
`obs.loadlab` sweeps:

  * **serve** (wall time) — the slot engine on a reduced LM config.
    Capacity is measured first (closed-loop: every request intended at
    t≈0, achieved rate = n / drain time), then the open-loop sweep
    offers 0.25x..6-8x that rate (deep past nominal, since the
    wall-clock capacity estimate is noisy) with Poisson arrivals and
    measures TTFT and end-to-end latency **from intended arrival
    times** generated up front on keyed streams — coordinated omission
    is structurally impossible, and the record self-asserts the guard
    (intended-based >= submit-based, strictly greater at overload).
  * **stream** (virtual time) — the fleet scheduler + modeled chip
    batches under per-patient Poisson segment arrivals at 0.25x..3x
    the modeled capacity, exactly reproducible on any host. A
    pinned URGENT cohort checks class survival: preemption must keep
    its p99.9 deadline slack non-negative through 3x overload.
  * **frontend** (wall time, loopback socket) — the async serving
    frontend (`serve.frontend`) with its admission bucket pinned to the
    serve sweep's measured knee, offered 0.25x/1x/3x that rate over a
    real TCP socket. Past the knee LM requests shed with typed
    rejections (accounting stays exact: submitted == completed +
    rejected), ROUTINE segments defer, URGENT segments always land. A
    paired in-process run at the lowest sub-knee point prices the
    transport itself (socket-minus-inproc tail delta).

Both sweeps locate the saturation knee (last point whose p99 stays
within 3x the fastest point's) and evaluate declared SLOs with
error-budget burn rates. A lineage pass then joins every traced
request's spans by request id across its subsystem hops
(serve: submit → admit → prefill/seat → decode → finish; stream:
enqueue → pack → flush → classify/vote) and samples per-request
critical paths for the report waterfall.

The record carries the shared `telemetry` schema section, like every
other benchmark. It is printed in summary, and written only where
`--out` says: never to the repository's BENCH_load.json, which holds the
JAX package's runs. `--report` renders the standalone HTML report, as
does

    python -m repro_torch.obs.loadlab RECORD.json -o load_report.html

    python -m repro_torch.benchmarks.load_sweep [--smoke] [--out PATH] \\
        [--report HTML]

`run(device="cpu")` runs it on the CPU; `device=None` means the CUDA
card and raises without one.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch import _device, configs, obs
from repro_torch.core import compiler, vadetect
from repro_torch.models import api
from repro_torch.obs import lineage, loadlab
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.frontend import Frontend, FrontendConfig, SocketClient
from repro_torch.stream.fleet import FleetConfig, simulate
from repro_torch.stream.runner import FleetRunner

ARCH = "qwen3_8b"
POOL = 4
PROMPT_LEN = 6


def build_serve(max_new: int, device: _device.DeviceLike = None):
    """(make_engine, make_prompts) closures over one built model —
    every sweep point gets a fresh engine (fresh slots/queue) but the
    params are shared, so per-point warmup is cheap."""
    dev = _device.resolve(device)
    cfg = configs.reduced(ARCH)
    model = api.build_model(cfg, tp=1, max_seq=PROMPT_LEN + max_new + 2)
    params = model.init(0, device=dev)

    def make_engine():
        return Engine(model, params, batch_size=POOL, device=dev)

    def make_prompts(n: int):
        gen = torch.Generator().manual_seed(7)
        toks = torch.randint(0, cfg.vocab, (n, PROMPT_LEN), generator=gen)
        return [toks[i] for i in range(n)]

    return make_engine, make_prompts


def measure_serve_capacity(make_engine, make_prompts, *, n: int,
                           max_new: int) -> float:
    """Closed-loop anchor: intend every request at ~t=0 (a very high
    offered rate), so the achieved rate is the drain throughput."""
    pt = loadlab.run_serve_point(
        make_engine,
        make_prompts(n),
        rate_rps=1e5,
        max_new=max_new,
        seed=99,
    )
    return float(pt["achieved_rps"])


def lineage_sample(runner, make_engine, make_prompts, *, max_new: int,
                   n_samples: int = 8) -> dict:
    """One traced run per engine, joined into per-request lineages.
    Kept separate from the sweeps (fresh tracer) so the join covers a
    bounded, fully-drained set of requests."""
    saved = obs.get()
    tel = obs.configure(enabled=True)
    try:
        # serve: enough requests to exercise queueing behind the pool
        eng = make_engine()
        for i, p in enumerate(make_prompts(POOL + 2)):
            eng.submit(Request(uid=i, prompt=p, max_new=max_new))
        eng.run(max_ticks=200)
        # stream: a small fleet, default periodic arrivals
        cfg = FleetConfig(
            n_patients=8, segments_per_patient=2, seed=0,
            buckets=(8,), va_fraction=0.0,
        )
        simulate(cfg, runner=runner)
        events = tel.tracer.events()
    finally:
        obs.install(saved)

    out = {}
    for name, prefix, min_hops in (
        ("serve", "serve:", 3), ("stream", "stream:", 3),
    ):
        joined = lineage.assert_joined(
            events, min_hops=min_hops, expect_prefix=prefix
        )
        mine = {r: h for r, h in joined.items() if r.startswith(prefix)}
        summ = lineage.summarize(
            [e for e in events
             if any(r.startswith(prefix) for r in lineage._event_rids(e))]
        )
        samples = []
        for rid in sorted(mine)[:n_samples]:
            cp = lineage.critical_path(mine[rid])
            cp["request_id"] = rid
            samples.append(cp)
        out[name] = {**summ, "min_hops_required": min_hops,
                     "samples": samples}
    return out


def frontend_lineage_sample(make_engine, runner, make_prompts, *,
                            max_new: int, n_lm: int = 6,
                            n_patients: int = 4,
                            n_samples: int = 8) -> dict:
    """Traced loopback-socket run with admission control off (nothing
    sheds), joined into per-request lineages: every request — LM and
    segment — must span >= 4 distinct hops INCLUDING the transport hop
    (client-minted ids survive the wire)."""
    import asyncio

    # warm under the ambient telemetry so the warmup requests'
    # uid>=1e6 lineages don't land in the sampled trace (they have no
    # transport hop and would trip the per-request assertion below)
    fe = Frontend(engine=make_engine(), n_patients=n_patients,
                  runner=runner, cfg=FrontendConfig())
    fe.warm(PROMPT_LEN)
    prompts = make_prompts(n_lm)

    saved = obs.get()
    tel = obs.configure(enabled=True)
    try:
        async def amain() -> None:
            host, port = await fe.start("127.0.0.1", 0)
            try:
                client = await SocketClient.connect(host, port)
                futs = []
                for i in range(n_lm):
                    futs.append(await client.send_lm(
                        uid=i, prompt=prompts[i].tolist(),
                        max_new=max_new,
                    ))
                for p in range(n_patients):
                    futs.append(await client.send_segment(
                        patient=p, seq=0, urgent=(p == 0)
                    ))
                for f in futs:
                    await asyncio.wait_for(f, 120.0)
                await client.drain()
                await client.close()
            finally:
                await fe.stop()

        asyncio.run(amain())
        events = tel.tracer.events()
    finally:
        obs.install(saved)

    joined = lineage.assert_joined(events, min_hops=4)
    for rid, hops in joined.items():
        assert any(h.name.startswith("frontend/") for h in hops), (
            rid, sorted({h.name for h in hops}),
        )
    summ = lineage.summarize(events)
    samples = []
    for rid in sorted(joined)[:n_samples]:
        cp = lineage.critical_path(joined[rid])
        cp["request_id"] = rid
        samples.append(cp)
    return {**summ, "min_hops_required": 4, "transport": "socket",
            "samples": samples}


def check(rec: dict) -> None:
    """The acceptance criteria: the record self-asserts its claims (the
    reference's assertions, unchanged)."""
    serve, stream = rec["serve"], rec["stream"]
    frontend, lin = rec["frontend"], rec["lineage"]
    fo = frontend["overload"]
    to = frontend["transport_overhead"]
    for name, sweep in (("serve", serve), ("stream", stream)):
        assert len(sweep["points"]) >= 5, (name, len(sweep["points"]))
        for p in sweep["points"]:
            assert None not in (
                p["p50_s"], p["p99_s"], p["p999_s"]
            ), (name, p)
        assert sweep["knee"]["detected"], (name, sweep["knee"])
        g = sweep["coordinated_omission_guard"]
        assert g["intended_ge_dequeue"], (name, g)
        assert g["strictly_greater_at_overload"], (name, g)
        assert sweep["overload"]["verdict"] == "graceful_degradation", (
            name, sweep["overload"],
        )
    assert serve["slo"]["met_sub_saturated"], serve["slo"]
    assert stream["slo"]["urgent_overload"]["met"], stream["slo"]
    assert stream["overload"]["urgent_survived"]
    assert stream["overload"]["never_dropped"]
    # frontend: graceful degradation at 3x the knee with exact
    # terminal accounting, typed rejections only, and zero URGENT
    # stream loss
    assert fo["verdict"] == "graceful_degradation", fo
    assert fo["accounting_exact"] and fo["typed_rejections_only"], fo
    assert fo["urgent_survived"], fo
    for p in frontend["points"]:
        assert p["submitted"] == p["completed"] + p["rejected"], p
        assert p["segments"]["urgent_not_enqueued"] == 0, p["segments"]
        assert p["segments"]["dropped"] == 0, p["segments"]
        if p["load_fraction"] <= 0.25:
            # burst-8 bucket at a quarter of the knee: shedding here
            # would mean the admission gate is mis-wired
            assert p["rejected"] == 0, p
        if p["load_fraction"] >= 3.0:
            assert p["rejected"] > 0, p  # the gate actually engages
    assert "socket_minus_inproc_p99_s" in to, to
    # every sampled request joins across >= 3 subsystem hops (>= 4 for
    # the frontend sample, which must also cross the transport)
    for name in ("serve", "stream"):
        assert lin[name]["requests"] > 0, lin[name]
        assert lin[name]["min_distinct_hops"] >= 3, lin[name]
    flin = lin["frontend"]
    assert flin["requests"] > 0, flin
    assert flin["min_distinct_hops"] >= 4, flin
    assert flin["requests_with_transport_hop"] == flin["requests"], flin
    t = rec["telemetry"]
    assert t["schema_version"] == obs.SCHEMA_VERSION and t["enabled"]


def run(smoke: bool = False, device: _device.DeviceLike = None) -> dict:
    """Run the three sweeps and the lineage pass with telemetry enabled
    and return the record; `check` holds it to the acceptance criteria
    (callers write and render it first, as the reference does, so a
    failing run leaves its evidence). The telemetry configured here stays
    installed, so a caller can write its trace."""
    dev = _device.resolve(device)
    # enabled from the start so every cell registers with the probe and
    # the sweeps' spans land in the telemetry section
    obs.configure(enabled=True)

    # serve sweeps push much deeper past nominal capacity than stream:
    # the serve capacity estimate is a *wall-clock* closed-loop drain
    # measurement, so on a noisy box it can come in 2-3x below the
    # true sustainable rate — a 3x top fraction then never actually
    # saturates the engine and no knee appears (seen in CI). The 6-8x
    # ceiling guarantees decisive saturation even through a 2-3x
    # capacity misestimate. Stream capacity is derived from the
    # *virtual-time* service model (deterministic), so 3x suffices.
    if smoke:
        serve_fractions = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0)
        stream_fractions = (0.25, 0.5, 0.75, 1.0, 2.0, 3.0)
        # n_requests is NOT shrunk for the smoke: with n requests the
        # worst open-loop queueing delay is bounded by ~(n-1)/capacity,
        # and the knee bound is 3x the *minimum* observed p99 — a noise
        # burst that inflates the quietest point by 2x can push the
        # bound past what n=16 requests can physically queue up,
        # leaving the knee undetectable (seen in CI). n=32 keeps the
        # saturated tail decisively above any noise-inflated bound.
        n_requests, max_new = 32, 8
        n_patients, segments_at_capacity = 16, 384
    else:
        serve_fractions = (0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 6.0)
        stream_fractions = (0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0)
        n_requests, max_new = 32, 8
        n_patients, segments_at_capacity = 64, 2048

    make_engine, make_prompts = build_serve(max_new, dev)
    capacity = measure_serve_capacity(
        make_engine, make_prompts, n=max(2 * POOL, 8), max_new=max_new
    )
    print(f"[load_sweep] serve closed-loop capacity ~{capacity:.0f} "
          f"req/s (pool={POOL}, prompt={PROMPT_LEN}, "
          f"max_new={max_new})")

    serve = loadlab.sweep_serve(
        make_engine,
        make_prompts,
        capacity_rps=capacity,
        load_fractions=serve_fractions,
        n_requests=n_requests,
        max_new=max_new,
    )
    print(f"[load_sweep] serve: knee@"
          f"{serve['knee'].get('knee_rate', float('nan')):.0f} req/s "
          f"(growth {serve['knee'].get('post_knee_growth', 0):.1f}x), "
          f"slo_sub_saturated={serve['slo']['met_sub_saturated']}, "
          f"verdict={serve['overload']['verdict']}")

    runner = FleetRunner(
        compiler.compile_model(vadetect.init(
            torch.Generator().manual_seed(0), device=dev)),
        device=dev,
    )
    stream = loadlab.sweep_stream(
        n_patients=n_patients,
        buckets=(8, 32),
        load_fractions=stream_fractions,
        segments_at_capacity=segments_at_capacity,
        runner=runner,
    )
    print(f"[load_sweep] stream: capacity "
          f"{stream['capacity_segments_per_s']:.0f} seg/s, knee@"
          f"{stream['knee'].get('knee_rate', float('nan')):.0f} "
          f"(growth {stream['knee'].get('post_knee_growth', 0):.1f}x), "
          f"urgent_survived={stream['overload']['urgent_survived']}, "
          f"verdict={stream['overload']['verdict']}")

    # frontend sweep: admission bucket pinned to the serve knee, loads
    # offered through a real loopback socket (wall time)
    knee_rate = float(serve["knee"].get("knee_rate") or capacity)

    def make_frontend(fcfg):
        fe = Frontend(engine=make_engine(), n_patients=8,
                      runner=runner, cfg=fcfg)
        fe.warm(PROMPT_LEN)
        return fe

    frontend = loadlab.sweep_frontend(
        make_frontend,
        make_prompts,
        admission_rate_rps=knee_rate,
        load_fractions=(0.25, 1.0, 3.0),
        n_requests=24,
        max_new=max_new,
        n_patients=8,
        segs_per_patient=3,
        urgent_fraction=0.25,
    )
    fo = frontend["overload"]
    to = frontend["transport_overhead"]
    print(f"[load_sweep] frontend: admission@{knee_rate:.0f} req/s "
          f"(serve knee), shed_curve="
          f"{[(c['load_fraction'], round(c['shed_rate'], 2)) for c in frontend['shed_curve']]}, "
          f"verdict={fo['verdict']} "
          f"(retention {fo['throughput_retention']:.2f})")
    print(f"[load_sweep] frontend transport: socket-inproc p99 "
          f"{to['socket_minus_inproc_p99_s'] * 1e3:+.2f}ms at "
          f"{to['load_fraction']}x")

    lin = lineage_sample(runner, make_engine, make_prompts,
                         max_new=max_new)
    lin["frontend"] = frontend_lineage_sample(
        make_engine, runner, make_prompts, max_new=max_new
    )
    for name in ("serve", "stream", "frontend"):
        print(f"[load_sweep] lineage[{name}]: "
              f"{lin[name]['requests']} requests joined, "
              f"{lin[name]['min_distinct_hops']}-"
              f"{lin[name]['max_distinct_hops']} distinct hops")

    rec = {
        "benchmark": "load_sweep",
        "smoke": bool(smoke),
        "device": {
            "type": dev.type,
            "name": (torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else "cpu"),
        },
        "serve": serve,
        "stream": stream,
        "frontend": frontend,
        "lineage": lin,
        "telemetry": obs.telemetry_section(),
    }
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced grid for CI")
    ap.add_argument("--out", default=None,
                    help="write the JSON record here (default: nowhere)")
    ap.add_argument("--report", default=None, metavar="HTML",
                    help="also render the standalone HTML report here")
    ap.add_argument("--trace-out", default=None, metavar="PREFIX",
                    help="write the lineage-pass trace to PREFIX.jsonl "
                         "+ PREFIX.json (Chrome/Perfetto)")
    args = ap.parse_args()
    rec = run(smoke=args.smoke)
    if args.trace_out:
        jsonl, chrome = obs.get().finish(args.trace_out)
        rec["trace"] = {"jsonl": jsonl, "chrome": chrome}
        print(f"[obs] trace written: {jsonl} + {chrome}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1, default=float)
        print(f"[load_sweep] -> {args.out}")
    if args.report:
        from repro_torch.obs import report

        print(f"[load_sweep] report -> "
              f"{report.render_report(rec, args.report)}")
    check(rec)
    print("[load_sweep] all assertions passed")


if __name__ == "__main__":
    main()

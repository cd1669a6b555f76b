"""Open-loop load lab: offered-load sweeps, saturation knees, SLO burn
(port of `repro.obs.loadlab`).

The closed-loop numbers the benchmarks report ("1000 patients
sustained") measure a system that is never asked to do more than it
can: a closed-loop driver waits for the previous response before
issuing the next request, so when the server slows down the *offered
load drops with it* and the tail you measure is the tail of a polite
workload. Real arrival processes are open-loop — implants close a
segment every 2.048 s whether or not the fleet is keeping up — and the
classic measurement bug under open loop is **coordinated omission**:
timing each request from when the load generator got around to
*sending* it (dequeue) instead of when it was *supposed to arrive*,
which silently excises exactly the queueing delay you were trying to
measure.

This module makes that bug structurally impossible:

  * arrival schedules are generated up front (`arrival_times`) on keyed
    streams — Poisson or trace-driven interarrivals, bitwise
    deterministic in (seed path, uid, rate, n, process, template) — so
    every request has an *intended* arrival time that exists before the
    system under test runs;
  * every latency is `completion − intended_arrival`. The sweep
    records the dequeue-based number too, but only to power the guard:
    intended-based latency ≥ dequeue-based latency always, strictly
    greater once a backlog forms (`co_guard`), and the load-sweep
    benchmark self-asserts that inequality.

Sweeps drive both engines across an offered-load grid (virtual time
for the stream fleet, wall time for the serve engine and the
frontend), locate the saturation knee (`locate_knee`), and evaluate
declared SLOs (`SLO.evaluate`) with error-budget burn accounting: burn
rate `(1 − ok_fraction) / (1 − target)` — 1.0 spends the error budget
exactly as fast as the SLO allows, >1 burns it faster.

Keying. The port cannot reproduce `jax.random` (threefry). Where the
reference draws on `fold_in(key, uid)`, a schedule here draws from
numpy's generator seeded by `SeedSequence([seed, uid])`; a nested key
extends the entropy list, so `fold_in(fold_in(PRNGKey(s), j), u)` is
`SeedSequence([s, j, u])`, and every function that takes a `seed`
takes an int or such a tuple (a seed path). The sites:

  * `sweep_serve`'s point j: seed path (seed, j); `run_serve_point`
    draws uid 0 on it, so the stream is [seed, j, 0];
  * `poisson_segment_refs`' patient p: [seed, p];
  * `sweep_frontend`'s point j: seed path (seed, j), the LM schedule on
    uid 0 and patient p's segments on uid 10 000 + p (disjoint, as in
    the reference); its transport twin reuses point 0's path (seed, 0).

The discipline is the reference's (one stream per key path, never
shared with signal content); the numbers are not.

CLI — render the standalone HTML report from a load-sweep record:

    python -m repro_torch.obs.loadlab RECORD.json -o load_report.html
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch import _device

ARRIVAL_PROCESSES = ("poisson", "trace")

# default trace-driven interarrival template: a bursty diurnal-ish
# pattern (mean 1 by construction after normalization) — callers pass
# their own recorded gaps for real trace replay
DEFAULT_TRACE_TEMPLATE = (
    0.2, 0.15, 0.3, 2.5, 0.2, 0.25, 1.8, 0.2, 0.3, 0.2, 3.0, 0.9,
)

# an int seed, or a seed path: the reference's nested fold_in keys
SeedPath = Union[int, Sequence[int]]


def seed_entropy(seed: SeedPath, *more: int) -> list[int]:
    """The `SeedSequence` entropy list of `seed` (an int or a path)
    extended by `more`: fold_in(...fold_in(PRNGKey(s), a)..., b) is
    [s, a, ..., b]."""
    path = [int(seed)] if np.ndim(seed) == 0 else [int(s) for s in seed]
    return path + [int(m) for m in more]


def interarrival_gaps(
    seed: SeedPath,
    uid: int,
    *,
    rate_hz: float,
    n: int,
    process: str = "poisson",
    template: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """(n,) interarrival gaps in seconds with mean 1/rate_hz.

    `poisson` draws exponential gaps (float32, as the reference) from the
    (seed path, uid) stream. `trace` replays `template` (normalized to
    mean 1, scaled to the rate) from a cyclic offset drawn from that
    stream, so different uids replay the same empirical shape out of
    phase.
    """
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be positive, got {rate_hz}")
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    rng = np.random.default_rng(np.random.SeedSequence(
        seed_entropy(seed, uid)))
    if process == "poisson":
        gaps = rng.standard_exponential(n, dtype=np.float32)
        return gaps.astype(np.float64) / rate_hz
    if process == "trace":
        tpl = np.asarray(
            template if template is not None else DEFAULT_TRACE_TEMPLATE,
            np.float64,
        )
        if tpl.size == 0 or (tpl <= 0).any():
            raise ValueError("trace template must be positive gaps")
        tpl = tpl / tpl.mean()  # mean-1 shape; rate sets the scale
        offset = int(rng.integers(0, tpl.size))
        idx = (offset + np.arange(n)) % tpl.size
        return tpl[idx] / rate_hz
    raise ValueError(
        f"unknown arrival process {process!r} "
        f"(want one of {ARRIVAL_PROCESSES})"
    )


def arrival_times(
    seed: SeedPath,
    uid: int,
    *,
    rate_hz: float,
    n: int,
    process: str = "poisson",
    template: Optional[Sequence[float]] = None,
    start_s: float = 0.0,
) -> np.ndarray:
    """(n,) intended absolute arrival times (cumsum of the gaps)."""
    return start_s + np.cumsum(
        interarrival_gaps(
            seed, uid, rate_hz=rate_hz, n=n,
            process=process, template=template,
        )
    )


# ---------------------------------------------------------------------------
# percentiles / knee
# ---------------------------------------------------------------------------


def tail_summary(samples: Sequence[float]) -> dict:
    """Exact p50/p99/p99.9 over raw samples (the sweep keeps raw
    latencies per point — point counts are bounded by the grid, so no
    histogram bucketing error enters the knee/SLO math)."""
    xs = np.asarray(list(samples), np.float64)
    if xs.size == 0:
        return {"count": 0, "p50_s": None, "p99_s": None,
                "p999_s": None, "max_s": None, "mean_s": None}
    return {
        "count": int(xs.size),
        "p50_s": float(np.quantile(xs, 0.50)),
        "p99_s": float(np.quantile(xs, 0.99)),
        "p999_s": float(np.quantile(xs, 0.999)),
        "max_s": float(xs.max()),
        "mean_s": float(xs.mean()),
    }


def locate_knee(
    points: list[dict],
    *,
    metric: str = "p99_s",
    rate_key: str = "offered_load",
    growth_factor: float = 3.0,
) -> dict:
    """Find the saturation knee on a sweep: the last offered-load point
    whose `metric` is still within `growth_factor` of the lowest-rate
    baseline. Everything past it is post-knee (queueing delay
    dominates and the tail grows with the backlog, not the service
    time).

    Returns {detected, knee_rate, baseline, post_knee_growth, ...};
    `detected` requires both sides of the knee to exist in the grid —
    at least one bounded sub-saturated point and at least one
    post-knee point with real growth.
    """
    pts = sorted(points, key=lambda p: p[rate_key])
    if len(pts) < 2:
        return {"detected": False, "reason": "fewer than 2 points"}
    # baseline: the *fastest* point (certainly sub-saturated) — robust
    # to a host hiccup landing on the lowest-rate point's p99
    baseline = min(
        (p[metric] for p in pts if p[metric] is not None),
        default=None,
    )
    if baseline is None or baseline <= 0:
        return {"detected": False, "reason": "no baseline"}
    bound = growth_factor * baseline
    below = [p for p in pts if p[metric] is not None and p[metric] <= bound]
    knee = below[-1] if below else pts[0]
    # post-knee points must lie *beyond* the knee rate — an outlier at
    # a low rate (host hiccup) is noise, not saturation
    above = [
        p for p in pts
        if p[metric] is not None
        and p[metric] > bound
        and p[rate_key] > knee[rate_key]
    ]
    detected = bool(below) and bool(above)
    worst = max(
        (p[metric] for p in above), default=baseline
    )
    return {
        "detected": detected,
        "metric": metric,
        "growth_factor": growth_factor,
        "baseline_s": float(baseline),
        "bound_s": float(bound),
        "knee_rate": float(knee[rate_key]),
        "first_post_knee_rate": (
            float(above[0][rate_key]) if above else None
        ),
        "post_knee_growth": float(worst / baseline),
        "n_sub_saturated": len(below),
        "n_post_knee": len(above),
    }


# ---------------------------------------------------------------------------
# SLOs + error-budget burn
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLO:
    """A declared objective: `target` fraction of requests must meet
    `bound` on `metric` (metric semantics live with the caller; this
    class only does the budget arithmetic)."""

    name: str
    metric: str  # e.g. "ttft_from_intended_s", "deadline_slack_s"
    bound: float  # good <=> sample meets the bound (caller-defined side)
    target: float  # e.g. 0.99 -> "p99 within bound"

    def evaluate(self, ok: int, total: int) -> dict:
        """Budget accounting for `ok` conforming samples out of
        `total`. burn_rate 1.0 consumes the error budget exactly at the
        allowed rate; >1 is over-budget (the SLO would page)."""
        if total <= 0:
            return {"slo": self.name, "total": 0, "met": None}
        ok_fraction = ok / total
        budget = 1.0 - self.target
        bad_fraction = 1.0 - ok_fraction
        burn = bad_fraction / budget if budget > 0 else math.inf
        return {
            "slo": self.name,
            "metric": self.metric,
            "bound": self.bound,
            "target": self.target,
            "total": int(total),
            "ok": int(ok),
            "ok_fraction": float(ok_fraction),
            "error_budget": float(budget),
            "burn_rate": float(burn),
            "met": bool(burn <= 1.0),
        }


def co_guard(
    from_intended: Sequence[float],
    from_dequeue: Sequence[float],
    *,
    saturated: bool,
) -> dict:
    """The coordinated-omission guard record. Latency measured from
    intended arrival can never be below the same request's latency
    measured from dequeue/submit (dequeue happens at or after the
    intended instant); once a backlog forms (`saturated`), it must be
    strictly greater on average — if the two agree under overload, the
    generator was closed-loop after all and the sweep is invalid."""
    a = np.asarray(list(from_intended), np.float64)
    b = np.asarray(list(from_dequeue), np.float64)
    if a.size == 0 or a.size != b.size:
        raise ValueError(
            f"guard needs paired samples, got {a.size} vs {b.size}"
        )
    # per-sample tolerance: the two clocks read the same completion,
    # so the inequality is exact up to timer quantization
    holds = bool(np.all(a >= b - 1e-9))
    excess = float((a - b).mean())
    record = {
        "measured_from": "intended_arrival",
        "samples": int(a.size),
        "intended_ge_dequeue": holds,
        "mean_queue_excess_s": excess,
        "saturated": bool(saturated),
        "strictly_greater_at_overload": bool(excess > 0)
        if saturated
        else None,
    }
    if not holds:
        raise AssertionError(
            "coordinated-omission guard violated: some latency "
            "measured from intended arrival is below the dequeue-based "
            "one — arrival schedule was not open-loop"
        )
    if saturated and excess <= 0:
        raise AssertionError(
            "coordinated-omission guard: no queueing excess at "
            "overload — the generator is coordinating with the server"
        )
    return record


# ---------------------------------------------------------------------------
# serve sweep (wall time)
# ---------------------------------------------------------------------------


def warm_engine(eng, prompt_len: int, *, vocab: int = 8) -> None:
    """Pay the first uses an open-loop point can hit before its clock
    starts — kernel builds, library handles, allocator growth — so they
    land outside every request's latency. The reference runs an admission
    group of every width 1..pool, because each width retraces its jitted
    prefill and seat cells; the port traces nothing per shape, so one
    group of the pool's width (the largest prefill, seat and pool decode)
    covers them, and on an engine that chunks `prompt_len`-token prompts,
    one such request covers the chunk cell."""
    import torch

    from repro_torch.serve.engine import Request

    chunk = eng.chunk_tokens
    short = prompt_len if chunk is None else min(prompt_len, chunk)
    lens = [short] * eng.batch + ([prompt_len] if short < prompt_len else [])
    for i, n in enumerate(lens):
        uid = 1_000_000 + i  # out of the clients' uid range
        eng.submit(Request(
            uid=uid,
            prompt=torch.full((n,), uid % vocab, dtype=torch.long),
            # 2 tokens: the first comes from prefill at admission, so the
            # request must survive into a slot to reach the seat and the
            # pool decode
            max_new=2,
        ))
    eng.run()


def run_serve_point(
    make_engine,
    prompts,
    *,
    rate_rps: float,
    max_new: int,
    seed: SeedPath,
    process: str = "poisson",
    template=None,
    max_wall_s: float = 120.0,
    warm: bool = True,
) -> dict:
    """Drive one fresh engine at one offered load (requests/s, wall
    time). `make_engine()` builds the engine; `prompts[i]` is request
    i's prompt. Latencies are measured from the *intended* arrival
    times (drawn on uid 0 of the seed path `seed`); submit-based twins
    ride along for the CO guard. A request's first-token and completion
    instants are taken when the host sees them after a tick."""
    import time

    from repro_torch.serve.engine import Request

    eng = make_engine()
    n = len(prompts)
    if warm:
        warm_engine(eng, int(prompts[0].shape[0]))
    intended = arrival_times(
        seed, 0, rate_hz=rate_rps, n=n, process=process, template=template
    )
    reqs = [
        Request(uid=i, prompt=prompts[i], max_new=max_new)
        for i in range(n)
    ]
    t_submit = np.zeros(n)
    t_first = np.full(n, np.nan)
    t_done = np.full(n, np.nan)
    seen_first = [False] * n
    submitted = 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if now > max_wall_s:
            raise RuntimeError(
                f"serve load point rate={rate_rps:.3f} exceeded "
                f"{max_wall_s}s wall budget"
            )
        while submitted < n and intended[submitted] <= now:
            eng.submit(reqs[submitted])
            t_submit[submitted] = time.perf_counter() - t0
            submitted += 1
        busy = eng.tick() > 0 or bool(eng._queue)
        now = time.perf_counter() - t0
        for i, r in enumerate(reqs[:submitted]):
            if r.output and not seen_first[i]:
                seen_first[i] = True
                t_first[i] = now
            if r.done and math.isnan(t_done[i]):
                t_done[i] = now
        if all(r.done for r in reqs):
            break
        if not busy and submitted < n:
            # idle until the next intended arrival (open loop: we do
            # NOT pull it forward)
            time.sleep(
                min(max(intended[submitted] - now, 0.0), 0.01)
            )
    ttft_intended = t_first - intended
    ttft_submit = t_first - t_submit
    lat_intended = t_done - intended
    achieved = n / max(float(t_done.max() - intended[0]), 1e-9)
    return {
        "offered_load": float(rate_rps),
        "n_requests": int(n),
        "achieved_rps": float(achieved),
        "ttft": tail_summary(ttft_intended),
        "ttft_from_submit": tail_summary(ttft_submit),
        "latency": tail_summary(lat_intended),
        "max_queue_delay_s": float((t_submit - intended).max()),
        "_raw": {
            "ttft_intended": ttft_intended,
            "ttft_submit": ttft_submit,
        },
        # the sweep's knee detector reads p99 of the intended-based
        # end-to-end latency
        "p50_s": tail_summary(lat_intended)["p50_s"],
        "p99_s": tail_summary(lat_intended)["p99_s"],
        "p999_s": tail_summary(lat_intended)["p999_s"],
    }


def sweep_serve(
    make_engine,
    make_prompts,
    *,
    capacity_rps: float,
    load_fractions: Sequence[float] = (0.25, 0.5, 0.75, 1.0, 1.5, 2.0),
    n_requests: int = 24,
    max_new: int = 8,
    seed: int = 0,
    process: str = "poisson",
    ttft_slo: Optional[SLO] = None,
) -> dict:
    """Offered-load sweep for the serve engine. `capacity_rps` anchors
    the grid (measure it closed-loop first); fractions > 1 are the
    overload points the verdict is judged on."""
    points = []
    for j, frac in enumerate(sorted(load_fractions)):
        rate = max(frac * capacity_rps, 1e-3)
        pt = run_serve_point(
            make_engine,
            make_prompts(n_requests),
            rate_rps=rate,
            max_new=max_new,
            seed=seed_entropy(seed, j),
            process=process,
        )
        pt["load_fraction"] = float(frac)
        points.append(pt)
    knee = locate_knee(points)
    overload = [p for p in points if p["load_fraction"] > 1.0]
    sub = [p for p in points if p["load_fraction"] <= 0.75]
    # CO guard is judged at the highest-load point, where the backlog
    # is guaranteed
    worst = max(points, key=lambda p: p["offered_load"])
    guard = co_guard(
        worst["_raw"]["ttft_intended"],
        worst["_raw"]["ttft_submit"],
        saturated=bool(overload),
    )
    slo = ttft_slo
    if slo is None:
        # calibrate the TTFT bound from the least-loaded point: an
        # order of magnitude above its p50 is comfortably met below
        # the knee and hopeless past it
        base = points[0]["ttft"]["p50_s"] or 0.01
        slo = SLO(
            name="serve.ttft.p99",
            metric="ttft_from_intended_s",
            bound=max(10.0 * base, 0.05),
            target=0.99,
        )
    slo_points = []
    for p in points:
        tt = p["_raw"]["ttft_intended"]
        slo_points.append({
            "offered_load": p["offered_load"],
            "load_fraction": p["load_fraction"],
            **slo.evaluate(int((tt <= slo.bound).sum()), len(tt)),
        })
    for p in points:
        del p["_raw"]  # raw arrays stay out of the JSON record
    sub_ok = [s for s in slo_points if s["load_fraction"] <= 0.75]

    # wall-clock noise robustness: open-loop tail latency is monotone
    # non-decreasing in offered load for a work-conserving server, so a
    # sub-saturated violation contradicted by a clean pass at STRICTLY
    # higher offered load is a host hiccup, not load — discount it (the
    # per-point burn rates still record it; only the aggregate verdict
    # ignores it)
    def _met_or_noise(s) -> bool:
        if s["met"]:
            return True
        return any(
            t["met"] and t["offered_load"] > s["offered_load"]
            for t in slo_points
        )
    verdict = "graceful_degradation"
    if overload:
        retention = min(
            p["achieved_rps"] for p in overload
        ) / max(capacity_rps, 1e-9)
        if retention < 0.5:
            verdict = "queue_collapse"
    else:
        retention = None
    return {
        "engine": "serve",
        "timebase": "wall",
        "capacity_rps": float(capacity_rps),
        "points": points,
        "knee": knee,
        "slo": {
            "declared": dataclasses.asdict(slo),
            "points": slo_points,
            "met_sub_saturated": all(_met_or_noise(s) for s in sub_ok)
            if sub_ok
            else None,
        },
        "coordinated_omission_guard": guard,
        "overload": {
            "verdict": verdict,
            "throughput_retention": retention,
        },
        "_sub_saturated_points": len(sub),
    }


# ---------------------------------------------------------------------------
# stream sweep (virtual time)
# ---------------------------------------------------------------------------


def poisson_segment_refs(
    *,
    n_patients: int,
    rate_segments_per_s: float,
    horizon_s: float,
    deadline_s: float,
    seed: int = 0,
    process: str = "poisson",
    template=None,
) -> list:
    """Open-loop per-patient arrival schedules for the stream fleet:
    patient p's segments arrive as a Poisson (or trace-driven) process
    at `rate_segments_per_s / n_patients`, drawn from the [seed, p]
    stream — deterministic, and independent across patients. Deadlines
    are arrival-relative, as in the periodic source."""
    from repro_torch.stream.sources import SegmentRef

    per_patient = rate_segments_per_s / n_patients
    # draw enough gaps to cover the horizon with margin, then clip
    n_draw = max(int(per_patient * horizon_s * 2) + 8, 8)
    refs = []
    for p in range(n_patients):
        t = arrival_times(
            seed, p, rate_hz=per_patient, n=n_draw,
            process=process, template=template,
        )
        t = t[t <= horizon_s]
        refs.extend(
            SegmentRef(
                patient=p,
                seq=int(s),
                arrival_s=float(ts),
                deadline_s=float(ts) + deadline_s,
            )
            for s, ts in enumerate(t)
        )
    refs.sort(key=lambda r: (r.arrival_s, r.patient, r.seq))
    return refs


def sweep_stream(
    *,
    n_patients: int = 64,
    buckets: tuple = (8, 32),
    load_fractions: Sequence[float] = (0.25, 0.5, 0.75, 1.0, 1.5, 2.0),
    segments_at_capacity: int = 2048,
    seed: int = 0,
    urgent_fraction: float = 0.125,
    process: str = "poisson",
    runner=None,
    device: _device.DeviceLike = None,
) -> dict:
    """Offered-load sweep for the stream fleet in virtual time. The
    capacity anchor is the modeled fleet rate for the largest bucket
    (bucket / `runner.batch_service_s(bucket)`); latency is modeled
    completion − intended arrival, so the sweep is exactly
    reproducible on any host. Every point runs the same virtual
    horizon (`segments_at_capacity / capacity` — so the 2x point
    offers ~2x the segments), the deadline is a fixed multiple of the
    largest bucket's service time, and a pinned URGENT cohort
    (`urgent_fraction` of patients) checks class survival under
    overload — preemption must keep their p99.9 deadline slack
    non-negative even when routine traffic is drowning. With no
    `runner`, the twin-path runner over `vadetect.init` drawn from
    `seed` is built on `device` (`None` meaning the CUDA card)."""
    from repro_torch.stream.fleet import FleetConfig, simulate
    from repro_torch.stream.runner import FleetRunner

    if runner is None:
        import torch

        from repro_torch.core import compiler, vadetect

        dev = _device.resolve(device)
        params = vadetect.init(torch.Generator().manual_seed(seed),
                               device=dev)
        runner = FleetRunner(compiler.compile_model(params), device=dev)

    service = runner.batch_service_s(buckets[-1])
    cap = buckets[-1] / service
    horizon_s = segments_at_capacity / cap
    # sub-saturated latency ~ bucket-fill wait + one service; overload
    # latency grows with the backlog toward the horizon scale. 12
    # service times comfortably covers the former and is far below the
    # latter, so violations appear exactly past the knee.
    deadline_s = 12.0 * service
    n_urgent = max(1, int(round(urgent_fraction * n_patients)))
    pinned = np.zeros(n_patients, bool)
    pinned[:n_urgent] = True

    points = []
    slack_urgent_overload_ok = 0
    slack_urgent_overload_total = 0
    urgent_slo = SLO(
        name="stream.urgent.deadline_slack.p999",
        metric="deadline_slack_s",
        bound=0.0,
        target=0.999,
    )
    slo_points = []
    for frac in sorted(load_fractions):
        rate = frac * cap
        refs = poisson_segment_refs(
            n_patients=n_patients,
            rate_segments_per_s=rate,
            horizon_s=horizon_s,
            deadline_s=deadline_s,
            seed=seed,
            process=process,
        )
        cfg = FleetConfig(
            n_patients=n_patients,
            segments_per_patient=1,  # unused: arrivals are explicit
            seed=seed,
            buckets=buckets,
            # signal content is irrelevant to the latency model; an
            # all-normal fleet keeps the synthetic generator cheap
            va_fraction=0.0,
        )
        out = simulate(
            cfg,
            runner=runner,
            arrivals=refs,
            pinned_urgent=pinned,
            collect_latency=True,
        )
        lat = out["latency"]
        latency = np.asarray(lat["latency_s"])
        slack = np.asarray(lat["slack_s"])
        # class membership by pinned cohort (stable across the sweep);
        # pack-time priority can additionally include vote-driven
        # urgency, which the lab deliberately doesn't score on
        prio = pinned[np.asarray(lat["patient"], int)]
        # intended-based vs dequeue-based: dequeue here is the pack
        # instant; completion − formed_at is the "polite" number the
        # CO guard forbids using
        from_dequeue = np.asarray(lat["latency_from_pack_s"])
        pt = {
            "offered_load": float(rate),
            "load_fraction": float(frac),
            "n_segments": int(latency.size),
            **{
                k: tail_summary(latency)[k]
                for k in ("p50_s", "p99_s", "p999_s", "count")
            },
            "latency": tail_summary(latency),
            "latency_urgent": tail_summary(latency[prio]),
            "latency_routine": tail_summary(latency[~prio]),
            "slack_ok_fraction": float((slack >= 0).mean()),
            "dropped": int(out["metrics"]["dropped_total"]),
            "queue_depth_max": int(out["metrics"]["queue_depth_max"]),
            "_raw": {
                "latency_intended": latency,
                "latency_dequeue": from_dequeue,
            },
        }
        points.append(pt)
        u_ok = int((slack[prio] >= 0).sum())
        u_tot = int(prio.sum())
        slo_points.append({
            "offered_load": pt["offered_load"],
            "load_fraction": float(frac),
            **urgent_slo.evaluate(u_ok, u_tot),
        })
        if frac > 1.0:
            slack_urgent_overload_ok += u_ok
            slack_urgent_overload_total += u_tot
    knee = locate_knee(points)
    worst = max(points, key=lambda p: p["offered_load"])
    guard = co_guard(
        worst["_raw"]["latency_intended"],
        worst["_raw"]["latency_dequeue"],
        saturated=any(p["load_fraction"] > 1.0 for p in points),
    )
    for p in points:
        del p["_raw"]
    overload_eval = urgent_slo.evaluate(
        slack_urgent_overload_ok, slack_urgent_overload_total
    )
    survived = bool(overload_eval.get("met"))
    no_drops = all(p["dropped"] == 0 for p in points)
    verdict = (
        "graceful_degradation"
        if survived and no_drops
        else "queue_collapse"
    )
    return {
        "engine": "stream",
        "timebase": "virtual",
        "capacity_segments_per_s": float(cap),
        "n_patients": int(n_patients),
        "urgent_patients": int(n_urgent),
        "points": points,
        "knee": knee,
        "slo": {
            "declared": dataclasses.asdict(urgent_slo),
            "points": slo_points,
            "urgent_overload": overload_eval,
        },
        "coordinated_omission_guard": guard,
        "overload": {
            "verdict": verdict,
            "urgent_survived": survived,
            "never_dropped": no_drops,
        },
    }


# ---------------------------------------------------------------------------
# frontend sweep (wall time, through the serving transport)
# ---------------------------------------------------------------------------


async def _frontend_point_async(
    make_frontend,
    prompts,
    *,
    rate_rps: float,
    max_new: int,
    seed: SeedPath,
    transport: str,
    n_patients: int,
    segs_per_patient: int,
    urgent_patients,
    seg_deadline_rel_s: float,
    process: str,
    max_wall_s: float,
) -> dict:
    import asyncio
    import time

    from repro_torch.serve.frontend import InProcClient, SocketClient

    fe = make_frontend()
    addr = await fe.start(
        host="127.0.0.1" if transport == "socket" else None, port=0
    )
    client = None
    try:
        client = (
            await SocketClient.connect(*addr)
            if transport == "socket"
            else InProcClient(fe)
        )
        n = len(prompts)
        intended = arrival_times(
            seed, 0, rate_hz=rate_rps, n=n, process=process
        )
        horizon = float(intended[-1])
        # per-patient segment schedules over the same wall horizon, on
        # uids disjoint from the LM schedule's
        seg_events = []
        if n_patients > 0 and segs_per_patient > 0:
            per_rate = segs_per_patient / max(horizon, 1e-3)
            for p in range(n_patients):
                ts = arrival_times(
                    seed, 10_000 + p, rate_hz=per_rate,
                    n=segs_per_patient, process=process,
                )
                seg_events.extend(
                    (float(t), p, s, bool(urgent_patients[p]))
                    for s, t in enumerate(ts)
                )
            seg_events.sort()
        t_send = np.zeros(n)
        lm_futs: list = [None] * n
        seg_futs: list = []
        t0 = time.perf_counter()

        async def drive_lm() -> None:
            for i in range(n):
                delay = intended[i] - (time.perf_counter() - t0)
                if delay > 0:
                    await asyncio.sleep(delay)
                lm_futs[i] = await client.send_lm(
                    uid=i, prompt=[int(x) for x in prompts[i].tolist()],
                    max_new=max_new,
                )
                t_send[i] = time.perf_counter() - t0

        async def drive_segs() -> None:
            for t, p, s, urg in seg_events:
                delay = t - (time.perf_counter() - t0)
                if delay > 0:
                    await asyncio.sleep(delay)
                seg_futs.append((p, s, urg, await client.send_segment(
                    p, s, deadline_rel_s=seg_deadline_rel_s, urgent=urg,
                )))

        # both generators are truly open-loop: they send on schedule
        # whether or not replies have come back
        await asyncio.wait_for(
            asyncio.gather(drive_lm(), drive_segs()), max_wall_s
        )
        results = [
            await asyncio.wait_for(f, max_wall_s) for f in lm_futs
        ]
        acks = [
            (p, s, urg, await asyncio.wait_for(f, max_wall_s))
            for p, s, urg, f in seg_futs
        ]
        stats = (await client.drain(timeout=max_wall_s))["stats"]
    finally:
        # the socket and the driver thread go with the point, whatever
        # became of it
        if client is not None:
            await client.close()
        await fe.stop()

    completed = [r for r in results if r["status"] == "completed"]
    rejected = [r for r in results if r["status"] == "rejected"]
    by_reason: dict[str, int] = {}
    for r in rejected:
        by_reason[r["reason"]] = by_reason.get(r["reason"], 0) + 1
    done_idx = [
        i for i, r in enumerate(results) if r["status"] == "completed"
    ]
    from_intended = np.asarray([
        results[i]["_t_recv"] - t0 - intended[i] for i in done_idx
    ])
    from_send = np.asarray([
        results[i]["_t_recv"] - t0 - t_send[i] for i in done_idx
    ])
    lat = tail_summary(from_intended)
    span = (
        max(
            results[i]["_t_recv"] - t0 for i in done_idx
        ) - float(intended[0])
        if done_idx else None
    )
    urgent_bad = sum(
        1 for _, _, urg, a in acks
        if urg and a["status"] != "enqueued"
    )
    deferred = sum(1 for *_, a in acks if a["status"] == "deferred")
    seg_rejected = sum(
        1 for *_, a in acks if a["status"] == "rejected"
    )
    # after a drain every enqueued segment must have been packed —
    # anything else is a silent scheduler drop
    dropped = int(
        stats.get("sched_enqueued_total", 0)
        - stats.get("sched_packed_total", 0)
    )
    return {
        "transport": transport,
        "offered_load": float(rate_rps),
        "n_requests": int(n),
        "submitted": int(n),
        "completed": len(completed),
        "rejected": len(rejected),
        "rejected_by_reason": by_reason,
        "shed_rate": len(rejected) / n,
        "accounting_exact": len(completed) + len(rejected) == n,
        "completed_rps": (
            len(completed) / max(span, 1e-9) if span else 0.0
        ),
        "latency": lat,
        "p50_s": lat["p50_s"],
        "p99_s": lat["p99_s"],
        "p999_s": lat["p999_s"],
        "segments": {
            "sent": len(acks),
            "urgent_sent": sum(1 for *_, u, _a in acks if u),
            "deferred": deferred,
            "rejected": seg_rejected,
            "urgent_not_enqueued": urgent_bad,
            "dropped": dropped,
        },
        "frontend_stats": stats,
        "_raw": {
            "from_intended": from_intended,
            "from_send": from_send,
        },
    }


def run_frontend_point(
    make_frontend,
    prompts,
    *,
    rate_rps: float,
    max_new: int,
    seed: SeedPath,
    transport: str = "socket",
    n_patients: int = 0,
    segs_per_patient: int = 0,
    urgent_patients=None,
    seg_deadline_rel_s: float = 0.5,
    process: str = "poisson",
    max_wall_s: float = 120.0,
) -> dict:
    """One offered-load point through the serving frontend
    (`serve.frontend`): an open-loop asyncio client sends LM requests
    at `rate_rps` (intended arrival schedule generated up front on uid
    0 of the seed path `seed`) and per-patient segment arrivals over
    the same horizon, over a loopback socket or the in-process
    transport. Every request's terminal outcome is collected —
    completed XOR an explicit typed rejection — along with
    shed/deferral/urgent accounting from the acks and the frontend's
    drain stats. The frontend is stopped (its driver thread joined, its
    socket closed) before this returns or raises.

    Unlike `run_serve_point`, the generator here is a separate async
    task from the server, so sends stay on schedule even at overload:
    the queueing excess lives server-side and shows up as shed rate
    and reply latency, not send lag. The CO twins (`from_intended` vs
    `from_send`) therefore agree to scheduler jitter — recorded, but
    the strict-inequality overload check is not applicable on this
    path."""
    import asyncio

    if urgent_patients is None:
        urgent_patients = np.zeros(max(n_patients, 1), bool)
    return asyncio.run(_frontend_point_async(
        make_frontend,
        prompts,
        rate_rps=rate_rps,
        max_new=max_new,
        seed=seed,
        transport=transport,
        n_patients=n_patients,
        segs_per_patient=segs_per_patient,
        urgent_patients=urgent_patients,
        seg_deadline_rel_s=seg_deadline_rel_s,
        process=process,
        max_wall_s=max_wall_s,
    ))


def sweep_frontend(
    make_frontend,
    make_prompts,
    *,
    admission_rate_rps: float,
    load_fractions: Sequence[float] = (0.25, 1.0, 3.0),
    n_requests: int = 24,
    max_new: int = 8,
    seed: int = 0,
    transport: str = "socket",
    n_patients: int = 8,
    segs_per_patient: int = 3,
    urgent_fraction: float = 0.25,
    seg_deadline_rel_s: float = 0.5,
    process: str = "poisson",
    compare_transports: bool = True,
) -> dict:
    """Offered-load sweep THROUGH the frontend transport, with active
    admission control at `admission_rate_rps` (wire it to
    `sweep_serve`'s measured knee). `make_frontend(cfg)` builds a
    fresh, warmed frontend from the per-sweep `FrontendConfig`.

    The verdict is judged on robust, deterministic signals — exact
    terminal accounting (submitted == completed + rejected, every shed
    an explicit typed rejection), URGENT segment survival (never
    deferred, never shed, never dropped, at any load), and completed-
    throughput retention at overload vs the best sub-knee point —
    rather than on wall-clock latency ratios, which a noisy host can
    fake either way. Tail latencies and the shed-rate curve past the
    knee are recorded alongside for the report."""
    from repro_torch.serve.frontend import FrontendConfig

    n_urgent = max(1, int(round(urgent_fraction * n_patients)))
    urgent_patients = np.zeros(n_patients, bool)
    urgent_patients[:n_urgent] = True
    # ROUTINE segment bucket: sized so the 1.0x point's segment rate
    # is exactly at the admission rate — overload points defer routine
    # traffic, demonstrating shed-vs-defer policy divergence
    seg_rate = (
        n_patients * segs_per_patient * admission_rate_rps
        / max(n_requests, 1)
    )
    fcfg = FrontendConfig(
        lm_queue_limit=max(4 * n_requests, 64),
        admission_rate_rps=admission_rate_rps,
        admission_burst=8.0,
        stream_rate_rps=seg_rate if n_patients > 0 else None,
        stream_burst=4.0,
        stream_buckets=(4, 8),
        stream_max_wait_s=0.02,
        seg_deadline_rel_s=seg_deadline_rel_s,
    )
    points = []
    for j, frac in enumerate(sorted(load_fractions)):
        pt = run_frontend_point(
            lambda: make_frontend(fcfg),
            make_prompts(n_requests),
            rate_rps=max(frac * admission_rate_rps, 1e-3),
            max_new=max_new,
            seed=seed_entropy(seed, j),
            transport=transport,
            n_patients=n_patients,
            segs_per_patient=segs_per_patient,
            urgent_patients=urgent_patients,
            seg_deadline_rel_s=seg_deadline_rel_s,
            process=process,
        )
        pt["load_fraction"] = float(frac)
        points.append(pt)
    # CO twins at the highest-load point: the async generator sends on
    # schedule, so intended >= send holds but the overload strictness
    # check does not apply (see run_frontend_point)
    worst = max(points, key=lambda p: p["offered_load"])
    guard = (
        co_guard(
            worst["_raw"]["from_intended"],
            worst["_raw"]["from_send"],
            saturated=False,
        )
        if worst["_raw"]["from_intended"].size
        else None
    )
    for p in points:
        del p["_raw"]
    overload = [p for p in points if p["load_fraction"] > 1.0]
    sub = [p for p in points if p["load_fraction"] <= 1.0]
    accounting_exact = all(p["accounting_exact"] for p in points)
    urgent_ok = all(
        p["segments"]["urgent_not_enqueued"] == 0
        and p["segments"]["dropped"] == 0
        for p in points
    )
    typed_only = all(
        sum(p["rejected_by_reason"].values()) == p["rejected"]
        for p in points
    )
    retention = None
    if overload:
        ref = max(
            (p["completed_rps"] for p in sub), default=None
        ) or admission_rate_rps
        retention = min(
            p["completed_rps"] for p in overload
        ) / max(ref, 1e-9)
    verdict = "graceful_degradation"
    if not (accounting_exact and urgent_ok and typed_only):
        verdict = "queue_collapse"
    elif retention is not None and retention < 0.5:
        verdict = "queue_collapse"
    out = {
        "engine": "frontend",
        "timebase": "wall",
        "transport": transport,
        "admission_rate_rps": float(admission_rate_rps),
        "admission_burst": float(fcfg.admission_burst),
        "stream_rate_rps": fcfg.stream_rate_rps,
        "n_patients": int(n_patients),
        "urgent_patients": int(n_urgent),
        "points": points,
        "shed_curve": [
            {"load_fraction": p["load_fraction"],
             "shed_rate": p["shed_rate"]}
            for p in points
        ],
        "coordinated_omission_guard": guard,
        "overload": {
            "verdict": verdict,
            "accounting_exact": accounting_exact,
            "urgent_survived": urgent_ok,
            "typed_rejections_only": typed_only,
            "throughput_retention": retention,
        },
    }
    if compare_transports and sub:
        # matched point on the other transport: the in-process client
        # enters the same handler with no socket hop, so the tail delta
        # prices the transport itself
        base = min(sub, key=lambda p: p["load_fraction"])
        other = "inproc" if transport == "socket" else "socket"
        twin = run_frontend_point(
            lambda: make_frontend(fcfg),
            make_prompts(n_requests),
            rate_rps=base["offered_load"],
            max_new=max_new,
            seed=seed_entropy(seed, 0),  # same schedule as point 0
            transport=other,
            n_patients=n_patients,
            segs_per_patient=segs_per_patient,
            urgent_patients=urgent_patients,
            seg_deadline_rel_s=seg_deadline_rel_s,
            process=process,
        )
        del twin["_raw"]
        pair = {transport: base, other: twin}
        out["transport_overhead"] = {
            "load_fraction": base["load_fraction"],
            "p50_s": {
                t: pair[t]["p50_s"] for t in pair
            },
            "p99_s": {
                t: pair[t]["p99_s"] for t in pair
            },
            "socket_minus_inproc_p50_s": (
                (pair["socket"]["p50_s"] or 0.0)
                - (pair["inproc"]["p50_s"] or 0.0)
            ),
            "socket_minus_inproc_p99_s": (
                (pair["socket"]["p99_s"] or 0.0)
                - (pair["inproc"]["p99_s"] or 0.0)
            ),
        }
    return out


# ---------------------------------------------------------------------------
# CLI: render the HTML report
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    import json

    from repro_torch.obs import report

    ap = argparse.ArgumentParser(
        description="render the standalone load-lab HTML report from a "
                    "load-sweep record"
    )
    ap.add_argument("bench", help="path to the load-sweep record (JSON)")
    ap.add_argument("-o", "--out", default="load_report.html")
    args = ap.parse_args(argv)
    with open(args.bench) as f:
        record = json.load(f)
    path = report.render_report(record, args.out)
    print(f"[obs.loadlab] wrote {path}")


if __name__ == "__main__":
    main()

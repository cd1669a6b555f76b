"""Virtual-time fleet simulation: sources → scheduler → runner → vote.

Port of `repro.stream.fleet`, on one device or, with `mesh=`, over the
ranks of a data mesh: every rank runs the same scheduler and vote on the
predictions the sharded runner gathers, and the caller reports from rank
0. This is the subsystem's
facade: wire a synthetic P-patient fleet through the deadline-aware
micro-batcher, the bucketed runner, and the vectorized vote machines
(their state on the runner's device), and report fleet metrics. Time is
two-track:

  * *virtual* time drives arrivals, deadlines, and modeled completions
    (each bucket costs `runner.batch_service_s` of chip-twin time), so
    deadline slack is a property of the modeled fleet, reproducible on
    any host;
  * *wall* time measures what this host and its card actually sustain
    (`segments_per_s_wall`, the host loop included), which is what the
    ≥real-time smoke criterion checks.

Signals can be pre-materialized (`pregen=True`, the default) so the
timed loop measures serving work — scheduling, packing, inference,
voting — not telemetry synthesis, which in deployment arrives from the
implants.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import _device, obs
from repro_torch.core import compiler, vadetect
from repro_torch.stream import vote as V
from repro_torch.stream.metrics import FleetMetrics
from repro_torch.stream.runner import FleetRunner
from repro_torch.stream.scheduler import (
    PRIORITY_URGENT,
    MicroBatchScheduler,
    SchedulerConfig,
)
from repro_torch.stream.sources import (
    SEGMENT_PERIOD_S,
    FleetSource,
    SourceConfig,
    advance_virtual_time,
    check_refs,
)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    n_patients: int = 64
    segments_per_patient: int = 6
    seed: int = 0
    va_fraction: float = 0.5
    jitter_frac: float = 0.0
    dropout: float = 0.0
    buckets: tuple[int, ...] = (8, 32, 128, 256)
    max_wait_s: float = 0.256
    path: str = "twin"
    pregen: bool = True
    # segment completion period; non-default values are for stress tests
    # (e.g. adversarially large virtual times exercising fp boundaries)
    period_s: float = SEGMENT_PERIOD_S

    def source_config(self) -> SourceConfig:
        return SourceConfig(
            n_patients=self.n_patients,
            seed=self.seed,
            va_fraction=self.va_fraction,
            jitter_frac=self.jitter_frac,
            dropout=self.dropout,
            period_s=self.period_s,
        )

    def scheduler_config(self) -> SchedulerConfig:
        return SchedulerConfig(
            buckets=self.buckets, max_wait_s=self.max_wait_s
        )


class _SignalBank:
    """Pre-materialized (patient, seq) → signal rows, built in chunks on
    the host."""

    def __init__(self, source: FleetSource, refs, chunk: int = 1024):
        pats = np.array([r.patient for r in refs], np.int64)
        seqs = np.array([r.seq for r in refs], np.int64)
        rows = [
            np.asarray(source.signals(pats[lo:lo + chunk],
                                      seqs[lo:lo + chunk])["signal"],
                       np.float32)
            for lo in range(0, len(refs), chunk)
        ]
        self._signals = (
            np.concatenate(rows) if rows else np.zeros((0, 512), np.float32)
        )
        self._index = {
            (int(p), int(s)): i for i, (p, s) in enumerate(zip(pats, seqs))
        }

    def gather(self, patients: np.ndarray, seqs: np.ndarray) -> np.ndarray:
        idx = np.fromiter(
            (
                self._index[(int(p), int(s))]
                for p, s in zip(patients, seqs)
            ),
            np.int64,
            count=len(patients),
        )
        return self._signals[idx]


def _record_flushes(tracer, parent: int, flushes: list,
                    runner: FleetRunner) -> None:
    """Record each batch's `stream/flush` span and its `stream/classify`
    and `stream/vote` children from the wall times the loop took: one
    request-id list per batch, taken at pack time and shared by every hop
    (the lineage join reads it back as `request_ids`)."""
    for (bucket, n_valid, rids, now, t0, t_classify, t_vote, t_voted,
         t1) in flushes:
        tagged = {"request_ids": rids} if rids is not None else {}
        flush = tracer.record(
            "stream/flush", "stream", t0, t1, parent,
            bucket=bucket, n_valid=n_valid, v_ts_s=now,
            v_dur_s=runner.batch_service_s(bucket), **tagged,
        )
        tracer.record("stream/classify", "stream", t_classify, t_vote, flush,
                      bucket=bucket, v_ts_s=now, **tagged)
        tracer.record("stream/vote", "stream", t_vote, t_voted, flush,
                      v_ts_s=now, **tagged)


def simulate(
    cfg: FleetConfig,
    program: Optional[compiler.AcceleratorProgram] = None,
    *,
    runner: Optional[FleetRunner] = None,
    device: _device.DeviceLike = None,
    mesh=None,
    collect_diagnoses: bool = False,
    arrivals=None,
    pinned_urgent=None,
    collect_latency: bool = False,
) -> dict:
    """Run the fleet for `segments_per_patient` segments per patient and
    return {metrics, chip, accuracy, ...}. Pass either a compiled
    `program` (a runner is built over it on `device`, `None` meaning the
    CUDA card; `program=None` compiles `vadetect.init` drawn from a
    generator seeded with `cfg.seed`) or a ready `runner`, whose device
    the run uses. `mesh` (a 1-D data `DeviceMesh`) splits each bucket
    over its ranks where the runner is built here; every rank of it calls
    `simulate` alike.

    Load-lab hooks: `arrivals` replaces the source's periodic schedule
    with an explicit `SegmentRef` list (the open-loop Poisson /
    trace-driven schedules `obs.loadlab` generates); `pinned_urgent`
    (bool (n_patients,)) pins the scheduler's URGENT bitmap to a fixed
    cohort — it *replaces* the vote layer's feedback, so class
    survival under overload is testable independent of what an
    untrained classifier happens to vote;
    `collect_latency=True` returns raw per-segment arrays under
    "latency" — `latency_s` (modeled completion − *intended arrival*,
    the coordinated-omission-safe measurement), `slack_s`, `urgent`
    (priority class at pack time), and `latency_from_pack_s`
    (completion − pack instant, the dequeue-based number the CO guard
    must dominate)."""
    if runner is None:
        dev = _device.resolve(device)
        if program is None:
            params = vadetect.init(
                torch.Generator().manual_seed(cfg.seed), device=dev
            )
            program = compiler.compile_model(params)
        runner = FleetRunner(program, path=cfg.path, device=dev, mesh=mesh)

    source = FleetSource(cfg.source_config())
    refs = (
        check_refs(list(arrivals), cfg.n_patients)
        if arrivals is not None
        else source.arrivals(cfg.segments_per_patient)
    )
    sched = MicroBatchScheduler(cfg.scheduler_config(), cfg.n_patients)
    if pinned_urgent is not None:
        pinned_urgent = np.asarray(pinned_urgent, bool)
        sched.set_urgent(pinned_urgent)
    vstate = V.init(cfg.n_patients, device=runner.device)
    metrics = FleetMetrics()
    bank = _SignalBank(source, refs) if cfg.pregen else None

    # the vote cell is probe-tracked like the classify cells
    vote_update = obs.get().probe.track("stream.vote", V.update)

    # warmup: every bucket shape once outside the timed region (kernel
    # builds, library autotuning, allocator growth)
    for b in cfg.buckets:
        obs.synchronize(runner.classify(
            np.zeros((b, vadetect.RECORD_LEN), np.float32)
        ))
        vote_update(
            vstate,
            np.zeros((b,), np.int32),
            np.zeros((b,), np.int32),
            np.zeros((b,), bool),
        )
    tel = obs.get()
    flush_hist = tel.registry.histogram("stream.flush_wall_s")
    # per batch (enabled telemetry): its bucket, rows, request ids, virtual
    # time and the wall times of its flush, classify and vote; the span
    # open around the loop is the flush spans' parent
    flushes = [] if tel.enabled else None
    stack = tel.tracer.open_stack() if tel.enabled else None
    parent = stack[-1] if stack else 0
    metrics.start_clock()

    chip_s_per_patient = np.zeros(cfg.n_patients)
    final_diag = np.full(cfg.n_patients, -1, np.int64)
    diagnoses = []
    lat_records = (
        {"latency_s": [], "slack_s": [], "urgent": [],
         "latency_from_pack_s": [], "patient": []}
        if collect_latency
        else None
    )
    i, now = 0, 0.0
    while i < len(refs) or sched.ready():
        if sched.ready() == 0 and i < len(refs):
            now = max(now, refs[i].arrival_s)
        while i < len(refs) and refs[i].arrival_s <= now:
            sched.enqueue(refs[i])
            i += 1
        drain = i >= len(refs)
        if not drain and not sched.should_flush(now):
            # advance virtual time to the next trigger: the next arrival
            # or the oldest queued segment aging past max_wait; if the
            # trigger cannot move time forward (fp boundary: at large
            # virtual times `oldest + max_wait` can round to <= now),
            # fall through and pack instead of spinning —
            # `should_flush`'s ulp-relative tolerance makes the two
            # sides of this boundary agree
            t_next = refs[i].arrival_s
            if sched.ready():
                t_next = min(
                    t_next, sched.oldest_arrival() + sched.cfg.max_wait_s
                )
            if t_next > now:
                now = t_next
                continue
        batch = sched.next_batch(now)
        if batch is None:
            continue
        # the flush / classify / vote spans are timed here and recorded
        # after the loop (`_record_flushes`): building them in the loop
        # cost more than the enabled-telemetry budget. Classify and vote
        # are NOT tel.block()ed (the reference blocks classify): their
        # results come back to the host in one copy below, and waiting
        # for classify would hold the vote's dispatch behind the card's
        # work only when telemetry is on (+38% of the loop on an H100).
        # So their wall durations are dispatch, the wait for the card
        # falls in the rest of the flush span, and the virtual track
        # (v_ts_s / v_dur_s on the flush span) carries modelled timing.
        t_flush = time.perf_counter()
        sigs = (
            bank.gather(batch.patients, batch.seqs)
            if bank is not None
            else np.asarray(
                source.signals(batch.patients, batch.seqs)["signal"]
            )
        )
        t_classify = time.perf_counter()
        preds = runner.classify(sigs)
        t_vote = time.perf_counter()
        vstate, emit, diag, urgent = vote_update(
            vstate,
            batch.patients,
            preds,
            batch.valid,
        )
        t_voted = time.perf_counter()
        # one copy to the host per batch: emit, diagnosis, urgent
        host = torch.stack(
            (emit.to(torch.int32), diag, urgent.to(torch.int32))
        ).cpu().numpy()
        t_flushed = time.perf_counter()
        flush_hist.observe(t_flushed - t_flush)
        if flushes is not None:
            flushes.append((batch.bucket, batch.n_valid, batch.request_ids,
                            now, t_flush, t_classify, t_vote, t_voted,
                            t_flushed))
        # masks/indices pinned: empty results must never decay to
        # float64 (the mark_urgent([]) class)
        emit_np = np.asarray(host[0], bool)
        sched.set_urgent(
            pinned_urgent
            if pinned_urgent is not None
            else np.asarray(host[2], bool)
        )

        service = runner.batch_service_s(batch.bucket)
        # forced minimum progress: at adversarially large virtual times
        # `now + service` can round back to exactly `now` (service below
        # one ulp), freezing completion times for the rest of the run
        completion = advance_virtual_time(now, now + service)
        now = completion
        valid = batch.valid
        np.add.at(
            chip_s_per_patient,
            batch.patients[valid],
            runner.chip_latency_s,
        )
        metrics.observe_batch(
            bucket=batch.bucket,
            n_valid=batch.n_valid,
            n_urgent=int(
                (batch.priorities[valid] == PRIORITY_URGENT).sum()
            ),
            slack_s=batch.deadlines[valid] - completion,
            queue_depth=sched.ready(),
            completion_s=completion,
        )
        if lat_records is not None:
            lat_records["latency_s"].append(
                completion - batch.arrivals[valid]
            )
            lat_records["slack_s"].append(
                batch.deadlines[valid] - completion
            )
            lat_records["urgent"].append(
                batch.priorities[valid] == PRIORITY_URGENT
            )
            lat_records["latency_from_pack_s"].append(
                np.full(int(valid.sum()),
                        completion - batch.formed_at_s)
            )
            lat_records["patient"].append(batch.patients[valid])
        if emit_np.any():
            diag_np = np.asarray(host[1], np.int64)
            who = np.nonzero(emit_np)[0]
            metrics.observe_diagnoses(
                len(who), int(diag_np[who].sum())
            )
            final_diag[who] = diag_np[who]
            if collect_diagnoses:
                diagnoses.extend(
                    (int(p), int(diag_np[p]), float(completion))
                    for p in who
                )
    metrics.stop_clock()
    if flushes:
        _record_flushes(tel.tracer, parent, flushes, runner)

    metrics.dropped_total = sched.enqueued_total - sched.packed_total
    tel.registry.counter("stream.dropped_total").add(metrics.dropped_total)
    labels = np.asarray(source.labels(np.arange(cfg.n_patients)))
    diagnosed = final_diag >= 0
    acc = (
        float((final_diag[diagnosed] == labels[diagnosed]).mean())
        if diagnosed.any()
        else float("nan")
    )
    # required aggregate real-time rate: one 512-sample segment per
    # patient per segment period (2.048 s at the paper's front end)
    required_rate = cfg.n_patients / cfg.period_s
    summ = metrics.summary()
    return {
        "config": {
            "n_patients": cfg.n_patients,
            "segments_per_patient": cfg.segments_per_patient,
            "buckets": list(cfg.buckets),
            "path": cfg.path,
            "n_devices": runner.n_devices,
            "jitter_frac": cfg.jitter_frac,
            "dropout": cfg.dropout,
        },
        "metrics": summ,
        "realtime": {
            "required_segments_per_s": required_rate,
            "sustained_segments_per_s": summ["segments_per_s_wall"],
            "realtime_factor": summ["segments_per_s_wall"]
            / max(required_rate, 1e-9),
        },
        "chip": {
            "latency_us_per_segment": runner.chip_latency_s * 1e6,
            "energy_nj_per_segment": runner.program.report.energy_j * 1e9,
            "modeled_fleet_segments_per_s": runner.modeled_segments_per_s(),
            "chip_s_per_patient_mean": float(chip_s_per_patient.mean()),
            "chip_s_per_patient_max": float(chip_s_per_patient.max()),
        },
        "accuracy": {
            "patients_diagnosed": int(diagnosed.sum()),
            "diagnostic_accuracy_synthetic": acc,
        },
        "jit_cache_misses": runner.jit_cache_misses(),
        "diagnoses": diagnoses if collect_diagnoses else None,
        "latency": (
            {
                k: (
                    np.concatenate(v)
                    if v
                    else np.zeros(0, {
                        "urgent": bool, "patient": np.int64,
                    }.get(k, np.float64))
                )
                for k, v in lat_records.items()
            }
            if lat_records is not None
            else None
        ),
    }

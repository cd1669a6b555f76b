"""Deadline-aware micro-batching scheduler for the monitoring fleet.

Port of `repro.stream.scheduler` (numpy; the same packing, batch for
batch). Packs ready segments from many patients into *fixed-shape*
padded device batches so the inference step only ever sees declared
shapes: every emitted batch is padded up to one of the declared bucket
sizes (`SchedulerConfig.buckets`), and the set of distinct shapes the
runner ever sees is exactly that tuple (`FleetRunner.jit_cache_misses`
counts them).

Two priority classes with preemption:

  * URGENT  — patients with a recent VA-positive segment (within
    `vote.URGENT_WINDOW` processed segments; the vote layer owns that
    state machine and feeds the bitmap back). Their queued segments are
    packed first, ahead of every routine segment, regardless of arrival
    order: a VA-suspect must clear the 6-segment vote as fast as
    possible because the next step is a defibrillation decision.
  * ROUTINE — everyone else.

Within a class, segments are packed in deadline order (earliest first),
so deadlines are monotone within a class across a batch and across
consecutive batches drained at the same instant. Queues are unbounded
and every enqueued segment is eventually packed exactly once — the
scheduler *never* drops (drops happen only at the source, as modeled
telemetry gaps).
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import threading
from time import perf_counter as _perf_counter

import numpy as np

from repro_torch import obs
from repro_torch.concurrency import driver_thread_only
from repro_torch.stream.sources import SEGMENT_PERIOD_S, SegmentRef
from repro_torch.stream.vote import VOTE_SEGMENTS

PRIORITY_URGENT = 0
PRIORITY_ROUTINE = 1


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    buckets: tuple[int, ...] = (8, 32, 128, 256)  # ascending batch shapes
    deadline_s: float = SEGMENT_PERIOD_S
    max_wait_s: float = 0.256  # time-trigger: flush a partial batch

    def __post_init__(self):
        assert self.buckets == tuple(sorted(self.buckets)), self.buckets
        assert all(b > 0 for b in self.buckets)


@dataclasses.dataclass
class PackedBatch:
    """One fixed-shape device batch. Arrays have length `bucket`; rows
    past `n_valid` are padding (patient/seq repeat the last valid row so
    the padded compute is well-formed; `valid` masks them out)."""

    patients: np.ndarray  # (bucket,) int32
    seqs: np.ndarray  # (bucket,) int32
    arrivals: np.ndarray  # (bucket,) float64 — virtual arrival times
    deadlines: np.ndarray  # (bucket,) float64
    priorities: np.ndarray  # (bucket,) int32 — class at pack time
    valid: np.ndarray  # (bucket,) bool
    bucket: int
    n_valid: int
    formed_at_s: float
    # lineage ids of the valid rows, taken once at pack time when
    # telemetry is enabled (None when disabled) — every downstream hop
    # (flush / classify / vote) attaches this same object instead of
    # re-deriving it; the strings are built when the trace is read
    request_ids: "RequestIds | None" = None


class RequestIds(obs.LazyAttr):
    """The `stream_rid` strings of a batch's first `n` (valid) rows,
    built when the trace is read: formatting them in the loop costs a
    tenth of a microsecond a segment, part of the enabled-telemetry
    budget."""

    __slots__ = ("patients", "seqs", "n", "_ids")

    def __init__(self, patients: np.ndarray, seqs: np.ndarray, n: int):
        self.patients = patients
        self.seqs = seqs
        self.n = n
        self._ids = None

    def resolve(self) -> list[str]:
        if self._ids is None:
            self._ids = [
                obs.stream_rid(p, s) for p, s in zip(
                    self.patients[:self.n].tolist(),
                    self.seqs[:self.n].tolist())
            ]
        return self._ids


class MicroBatchScheduler:
    """Admission queue + pad-to-bucket packer with urgent preemption."""

    def __init__(self, cfg: SchedulerConfig, n_patients: int):
        self.cfg = cfg
        self.n_patients = n_patients
        # (admission_index, ref) pairs: the index is the FIFO tiebreak
        # for equal deadlines AND the removal key at pack time — unique
        # per enqueue even if one ref object is enqueued twice (e.g. a
        # retransmission path), so 'never drops' holds per enqueue
        self._queue: list[tuple[int, SegmentRef]] = []
        self._tie = itertools.count()
        # cached min arrival over the queue: maintained at enqueue
        # (min is monotone under insertion), invalidated when `_pack`
        # removes entries, lazily recomputed on the next read. None
        # means stale; an empty queue short-circuits before the cache
        # is consulted.
        self._oldest_cache: float | None = None
        # urgency bitmap: owned by the vote layer's per-patient state
        # machine (`stream.vote.update` returns it); the scheduler only
        # *consumes* it at pack time.
        self._urgent = np.zeros(n_patients, bool)
        # segments packed so far per patient == the vote layer's
        # processed count (every packed row goes straight to one
        # vote.update); used to align batches to vote windows
        self._packed_count = np.zeros(n_patients, np.int64)
        self.enqueued_total = 0
        self.packed_total = 0
        # packs buffered for the enabled tracer (`_start_trace_log`), and
        # the admissions already added to its enqueued counter
        self._packs: list[tuple] = []
        self._log_tracer = self._log_stack = self._enqueued = None
        self._enqueued_counted = 0
        # admission windows for the trace: (admissions so far, wall time)
        # at the start and at the end of each traced pack. A segment's
        # `stream/enqueue` instant carries the start of the window it was
        # admitted in: reading the clock at each admission took most of
        # the fleet loop's 3% telemetry budget on an H100 machine
        self._windows_n: list[int] = [0]
        self._windows_t: list[float] = [_perf_counter()]

    # -- admission ----------------------------------------------------------

    @driver_thread_only
    def enqueue(self, ref: SegmentRef) -> None:
        if not self._queue:
            self._oldest_cache = ref.arrival_s
        elif self._oldest_cache is not None and (
            ref.arrival_s < self._oldest_cache
        ):
            self._oldest_cache = ref.arrival_s
        self._queue.append((next(self._tie), ref))
        self.enqueued_total += 1

    def _start_trace_log(self, tel) -> None:
        """A new pack buffer, registered with `tel`'s tracer, which
        drains it into `stream/pack` spans and the `stream/enqueue`
        instants of the segments each pack took (at the start of their
        admission window: `_windows_t`); the driver thread's open-span
        stack, whose top is the parent of both; and the
        `stream.enqueued_total` counter, which catches up at each pack."""
        packs: list[tuple] = []
        tid = threading.get_ident() & 0xFFFF  # the driver thread
        windows_n, windows_t = self._windows_n, self._windows_t

        def drain() -> list[tuple]:
            out = []
            for t0, t1, parent, depth, now_s, rids, take in packs:
                out.extend(
                    ("stream/enqueue", "stream",
                     windows_t[bisect.bisect_right(windows_n, order) - 1],
                     None, parent, tid,
                     {"request_id": obs.stream_rid(r.patient, r.seq),
                      "v_ts_s": r.arrival_s})
                    for order, r in take
                )
                out.append(
                    ("stream/pack", "stream", t0, t1, parent, tid,
                     {"queue_depth": depth, "v_ts_s": now_s,
                      "request_ids": rids}))
            packs.clear()
            return out

        tel.tracer.defer(drain)
        self._packs = packs
        self._log_tracer = tel.tracer
        self._log_stack = tel.tracer.open_stack()
        self._enqueued = tel.registry.counter("stream.enqueued_total")

    @driver_thread_only
    def extend(self, refs) -> None:
        for r in refs:
            self.enqueue(r)

    # -- urgency feedback (from stream.vote) --------------------------------

    @driver_thread_only
    def set_urgent(self, urgent: np.ndarray) -> None:
        """Overwrite the urgency bitmap (one bool per patient)."""
        urgent = np.asarray(urgent, bool)
        assert urgent.shape == (self.n_patients,), urgent.shape
        self._urgent = urgent.copy()

    @driver_thread_only
    def mark_urgent(self, patients, flag: bool = True) -> None:
        # force an integer index dtype: `np.asarray([])` defaults to
        # float64, and float-array indexing raises even for zero
        # elements — an empty update (no patients changed state this
        # tick) must be a no-op, not a crash
        idx = np.asarray(patients, np.intp)
        if idx.size:
            self._urgent[idx] = flag

    def is_urgent(self, patient: int) -> bool:
        return bool(self._urgent[patient])

    # -- introspection ------------------------------------------------------

    def ready(self) -> int:
        return len(self._queue)

    def earliest_deadline(self) -> float:
        if not self._queue:
            return float("inf")
        return min(r.deadline_s for _, r in self._queue)

    def oldest_arrival(self) -> float:
        """Min arrival over the queue, O(1) amortized: `should_flush`
        polls this every iteration of the virtual-time loop, and a full
        min-scan per poll is O(n²) per drain cycle at fleet backlogs.
        The cache is maintained incrementally at enqueue and recomputed
        at most once per pack (the only removal point)."""
        if not self._queue:
            return float("inf")
        if self._oldest_cache is None:
            self._oldest_cache = min(r.arrival_s for _, r in self._queue)
        return self._oldest_cache

    def should_flush(self, now_s: float) -> bool:
        """Size trigger (a full largest bucket is ready) or time trigger
        (the oldest queued segment has waited max_wait_s)."""
        if not self._queue:
            return False
        if len(self._queue) >= self.cfg.buckets[-1]:
            return True
        # tolerance guards the fp boundary now == oldest + max_wait,
        # where (oldest + max_wait) - oldest can round below max_wait
        # and livelock a virtual-time loop that advances `now` to the
        # trigger. The rounding error is an ulp of the *operand
        # magnitude* — at large virtual times (adversarial jitter, long
        # horizons) it dwarfs any fixed epsilon — so the tolerance is a
        # few ulp of the larger operand, floored at the old 1e-9.
        oldest = self.oldest_arrival()
        tol = max(1e-9, 4.0 * np.spacing(max(abs(now_s), abs(oldest))))
        return now_s - oldest >= self.cfg.max_wait_s - tol

    # -- packing ------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.cfg.buckets:
            if n <= b:
                return b
        return self.cfg.buckets[-1]

    @driver_thread_only
    def next_batch(self, now_s: float) -> PackedBatch | None:
        """Pack up to largest-bucket segments: urgent first, then
        routine, each class in (deadline, admission) order; pad the
        result up to the smallest declared bucket that fits.

        A patient's rows in one batch never cross a 6-segment vote
        window boundary: the per-batch cap is the remaining slots in
        the patient's current window (VOTE_SEGMENTS − packed % 6). The
        vote layer's scatter addresses ring slot (count + in-batch
        rank) % 6 and votes once at end of batch, so a straddling batch
        would overwrite pre-boundary slots before the vote. A
        backlogged patient just drains through consecutive batches —
        still never dropped, excess rows stay queued."""
        if not self._queue:
            return None
        tel = obs.get()
        if tel.enabled:
            # the `stream/pack` span, timed here and built when the
            # trace is read; which segments it chose is only known now,
            # so it joins each one's lineage
            if tel.tracer is not self._log_tracer:
                self._start_trace_log(tel)
            stack = self._log_stack
            depth = len(self._queue)
            t0 = _perf_counter()
            batch, take = self._pack(now_s)
            t1 = _perf_counter()
            batch.request_ids = RequestIds(
                batch.patients, batch.seqs, batch.n_valid)
            self._packs.append((t0, t1, stack[-1] if stack else 0, depth,
                                now_s, batch.request_ids, take))
            self._windows_n.append(self.enqueued_total)
            self._windows_t.append(t1)
            # the enqueue counter catches up here, once a batch
            self._enqueued.add(self.enqueued_total - self._enqueued_counted)
            self._enqueued_counted = self.enqueued_total
        else:
            batch, _ = self._pack(now_s)
        tel.registry.counter("stream.packed_total").inc(batch.n_valid)
        tel.registry.gauge("stream.queue_depth").set(len(self._queue))
        return batch

    def _pack(self, now_s: float) -> tuple[PackedBatch, list[tuple]]:
        """The batch, and the queue entries it took."""
        urgent, routine = [], []
        for entry in self._queue:
            (urgent if self.is_urgent(entry[1].patient)
             else routine).append(entry)
        key = lambda e: (e[1].deadline_s, e[0])
        urgent.sort(key=key)
        routine.sort(key=key)
        take, take_prio = [], []
        per_patient: dict[int, int] = {}
        for order, r in urgent + routine:
            if len(take) >= self.cfg.buckets[-1]:
                break
            c = per_patient.get(r.patient, 0)
            window_left = VOTE_SEGMENTS - (
                int(self._packed_count[r.patient]) % VOTE_SEGMENTS
            )
            if c >= window_left:
                continue
            per_patient[r.patient] = c + 1
            take.append((order, r))
            take_prio.append(
                PRIORITY_URGENT
                if self.is_urgent(r.patient)
                else PRIORITY_ROUTINE
            )
        for p, c in per_patient.items():
            self._packed_count[p] += c
        taken = {order for order, _ in take}
        self._queue = [e for e in self._queue if e[0] not in taken]
        # removal can only raise the min — invalidate; the next
        # `oldest_arrival` recomputes once over the survivors
        self._oldest_cache = None
        self.packed_total += len(take)

        n = len(take)
        bucket = self._bucket_for(n)
        pad = bucket - n
        rows = [r for _, r in take]
        rows = rows + [rows[-1]] * pad
        prio = np.full(bucket, PRIORITY_ROUTINE, np.int32)
        prio[:n] = take_prio
        return PackedBatch(
            patients=np.array([r.patient for r in rows], np.int32),
            seqs=np.array([r.seq for r in rows], np.int32),
            arrivals=np.array([r.arrival_s for r in rows], np.float64),
            deadlines=np.array([r.deadline_s for r in rows], np.float64),
            priorities=prio,
            valid=np.arange(bucket) < n,
            bucket=bucket,
            n_valid=n,
            formed_at_s=now_s,
        ), take

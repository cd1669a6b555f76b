"""Per-patient continuous IEGM streams for the monitoring fleet.

Port of `repro.stream.sources`. Two views of the same telemetry, both
deterministic in (seed, patient, seq) via `data.iegm.segment_batch`'s
per-row seeding:

  * `RingBuffer` — the device-side view: raw samples arrive at 250 Hz
    into a per-patient ring; every 512 accumulated samples close one
    segment. This is what a single implant's ingest path looks like
    (`serve.va_service` is the single-patient facade over it).
  * `FleetSource` — the fleet-side view: a virtual-time arrival process
    over P patients. Segment k of patient p nominally completes at
    (k+1) * 2.048 s; per-segment arrival jitter models uplink latency
    variance and `dropout` models telemetry gaps (a dropped segment
    never reaches the scheduler — it is a *source* loss, distinct from
    a scheduler drop, which `stream.scheduler` guarantees never
    happens). Signal content is materialized lazily in batches so a
    1000-patient fleet never holds per-patient Python state. The arrival
    process is the reference's numpy draw, so the port's schedule is
    the reference's, element for element.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data import iegm

SEGMENT_PERIOD_S = iegm.RECORD_LEN / iegm.SAMPLE_RATE_HZ  # 2.048 s


def advance_virtual_time(now_s: float, target_s: float) -> float:
    """Monotone advance for virtual-time event loops: max(target,
    nextafter(now)) — strictly greater than `now_s` even when fp
    cancellation rounds `target_s` at or below it.

    The boundary this guards: a loop that derives a trigger like
    `oldest + max_wait` and then re-tests `now - oldest >= max_wait`
    can livelock, because `(a + b) - a >= b` is not guaranteed in
    float64 — and at large virtual times (days of 2.048 s segments, or
    adversarial jitter pushing arrivals far out) the rounding error is
    an *ulp of the magnitude*, far larger than any fixed epsilon. Every
    advance-time assignment in `fleet.simulate` goes through here so
    accumulated float jitter can never stall the event loop; the flush
    predicate side is `scheduler.should_flush`'s ulp-relative
    tolerance."""
    return max(float(target_s), float(np.nextafter(now_s, np.inf)))


class RingBuffer:
    """Sample-level ring buffer: push raw samples, pop full segments.

    Capacity is a whole number of segments; `push` returns every segment
    completed by the pushed samples (zero or more). Overwrite-on-full
    drops the *oldest unclosed* samples, mirroring the front-end SRAM.
    """

    def __init__(self, segments: int = 2, record_len: int = iegm.RECORD_LEN):
        self.record_len = record_len
        self._buf = np.zeros(segments * record_len, np.float32)
        self._write = 0  # total samples ever written
        self._read = 0  # total samples consumed into segments

    def push(self, samples: np.ndarray) -> list[np.ndarray]:
        samples = np.asarray(samples, np.float32).ravel()
        cap = self._buf.size
        for s in samples:
            if self._write - self._read >= cap:  # full: drop oldest
                self._read += 1
            self._buf[self._write % cap] = s
            self._write += 1
        out = []
        while self._write - self._read >= self.record_len:
            idx = (self._read + np.arange(self.record_len)) % cap
            out.append(self._buf[idx].copy())
            self._read += self.record_len
        return out

    @property
    def fill(self) -> int:
        return self._write - self._read


@dataclasses.dataclass(frozen=True)
class SourceConfig:
    n_patients: int
    seed: int = 0
    va_fraction: float = 0.5  # prior prob. a patient's condition is VA
    jitter_frac: float = 0.0  # arrival jitter std, fraction of period
    dropout: float = 0.0  # prob. a segment's telemetry never arrives
    period_s: float = SEGMENT_PERIOD_S


@dataclasses.dataclass(frozen=True)
class SegmentRef:
    """Metadata of one in-flight segment (signal materialized later)."""

    patient: int
    seq: int
    arrival_s: float
    deadline_s: float


def check_refs(refs: list[SegmentRef], n_patients: int) -> list[SegmentRef]:
    """Validate an externally-built arrival schedule before the fleet
    loop consumes it (the open-loop load lab hands `fleet.simulate`
    explicit schedules in place of `FleetSource.arrivals`): patients in
    range, (patient, seq) identities unique — signal content is keyed
    on them, so a duplicate would silently classify the same segment
    twice — deadlines after arrivals, and arrival-sorted order (the
    event loop pops the head). Returns `refs` unchanged."""
    seen: set[tuple[int, int]] = set()
    prev = -np.inf
    for r in refs:
        if not 0 <= r.patient < n_patients:
            raise ValueError(
                f"SegmentRef patient {r.patient} outside fleet of "
                f"{n_patients}"
            )
        ident = (r.patient, r.seq)
        if ident in seen:
            raise ValueError(f"duplicate SegmentRef identity {ident}")
        seen.add(ident)
        if not (r.deadline_s > r.arrival_s >= 0.0):
            raise ValueError(
                f"SegmentRef {ident} needs deadline > arrival >= 0, "
                f"got arrival={r.arrival_s} deadline={r.deadline_s}"
            )
        if r.arrival_s < prev:
            raise ValueError(
                "arrival schedule must be sorted by arrival_s "
                f"(violated at {ident})"
            )
        prev = r.arrival_s
    return refs


class FleetSource:
    """Virtual-time arrival process + lazy batched signal materializer."""

    def __init__(self, cfg: SourceConfig, *, deadline_s: float | None = None):
        self.cfg = cfg
        # deadline: classify before the patient's next segment completes
        self.deadline_s = cfg.period_s if deadline_s is None else deadline_s

    def arrivals(self, segments_per_patient: int) -> list[SegmentRef]:
        """All segment arrivals for the horizon, sorted by arrival time.

        Host-side numpy event process (jitter/dropout), deterministic in
        the seed; signal *content* is seeded per (patient, seq), so the
        two never interact.
        """
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        p = cfg.n_patients
        k = segments_per_patient
        seqs = np.arange(k)
        nominal = (seqs[None, :] + 1.0) * cfg.period_s  # (1, K)
        jitter = (
            rng.normal(0.0, cfg.jitter_frac * cfg.period_s, (p, k))
            if cfg.jitter_frac > 0
            else np.zeros((p, k))
        )
        t = np.maximum(nominal + jitter, 1e-6)  # (P, K)
        keep = (
            rng.random((p, k)) >= cfg.dropout
            if cfg.dropout > 0
            else np.ones((p, k), bool)
        )
        refs = [
            SegmentRef(
                patient=pi,
                seq=int(seqs[ki]),
                arrival_s=float(t[pi, ki]),
                deadline_s=float(t[pi, ki]) + self.deadline_s,
            )
            for pi in range(p)
            for ki in range(k)
            if keep[pi, ki]
        ]
        refs.sort(key=lambda r: (r.arrival_s, r.patient, r.seq))
        return refs

    def signals(
        self, patients: np.ndarray, seqs: np.ndarray
    ) -> dict[str, torch.Tensor]:
        """{signal (B, 512), label (B,)} for (patient, seq) rows, on the
        host: telemetry arrives there from the implants, and the runner
        copies each packed batch to its device."""
        return iegm.segment_batch(
            self.cfg.seed, patients, seqs,
            va_fraction=self.cfg.va_fraction, device="cpu",
        )

    def labels(self, patients: np.ndarray) -> torch.Tensor:
        """Ground-truth per-patient condition (for accuracy accounting)."""
        return iegm.patient_labels(
            self.cfg.seed, patients, self.cfg.va_fraction
        )

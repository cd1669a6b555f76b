"""Fleet counters: throughput, deadline slack percentiles, queue depth.

Port of `repro.stream.metrics` (numpy; the same summary, key for key).
One `FleetMetrics` instance rides along the fleet loop; `observe_batch`
is called once per packed batch with virtual-time slack per segment
(deadline − modeled completion), and `summary()` folds everything into
the dict the benchmark serializes.

Slack lives in a shared `obs` signed log-bucket histogram —
O(buckets) memory however many segments flow through. Bucketed
percentiles trade ≤ one log-bucket of quantile error — ~21% relative at
12 buckets/decade — for a fixed footprint; `min` and the violation
count stay exact: the histogram tracks extremes exactly and 0 is an
explicit bucket edge. Queue depth keeps running sum/count/max.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.obs import Histogram


@dataclasses.dataclass
class FleetMetrics:
    segments_total: int = 0
    padded_total: int = 0  # padding rows (wasted chip slots)
    batches_total: int = 0
    diagnoses_total: int = 0
    va_diagnoses_total: int = 0
    urgent_packed_total: int = 0
    dropped_total: int = 0  # scheduler drops — must stay 0
    virtual_horizon_s: float = 0.0  # last modeled completion time

    def __post_init__(self):
        # signed layout: slack is negative exactly when the deadline
        # was violated
        self._slack = Histogram("stream.deadline_slack_s", "signed")
        self._violations = 0  # exact strict (< 0) count
        self._depth_sum = 0
        self._depth_n = 0
        self._depth_max = 0
        self._bucket_counts: dict[int, int] = {}
        self._t0 = time.perf_counter()
        self._wall_s: float | None = None

    # -- lifecycle ----------------------------------------------------------

    def start_clock(self) -> None:
        """(Re)start the wall clock — call after warmup/compile."""
        self._t0 = time.perf_counter()
        self._wall_s = None

    def stop_clock(self) -> None:
        self._wall_s = time.perf_counter() - self._t0

    @property
    def wall_s(self) -> float:
        return (
            self._wall_s
            if self._wall_s is not None
            else time.perf_counter() - self._t0
        )

    @property
    def slack_histogram(self) -> Histogram:
        """The mergeable per-shard slack histogram (telemetry export)."""
        return self._slack

    # -- observation --------------------------------------------------------

    def observe_batch(
        self,
        *,
        bucket: int,
        n_valid: int,
        n_urgent: int,
        slack_s: np.ndarray,  # (n_valid,) deadline − completion, virtual
        queue_depth: int,
        completion_s: float,
    ) -> None:
        self.batches_total += 1
        self.segments_total += n_valid
        self.padded_total += bucket - n_valid
        self.urgent_packed_total += n_urgent
        slack = np.asarray(slack_s, np.float64)
        self._slack.observe_array(slack)
        self._violations += int((slack < 0).sum())
        self._depth_sum += queue_depth
        self._depth_n += 1
        self._depth_max = max(self._depth_max, queue_depth)
        self._bucket_counts[bucket] = self._bucket_counts.get(bucket, 0) + 1
        self.virtual_horizon_s = max(self.virtual_horizon_s, completion_s)

    def observe_diagnoses(self, n: int, n_va: int) -> None:
        self.diagnoses_total += n
        self.va_diagnoses_total += n_va

    # -- report -------------------------------------------------------------

    def summary(self) -> dict:
        wall = max(self.wall_s, 1e-9)
        vh = max(self.virtual_horizon_s, 1e-9)
        out = {
            "segments_total": self.segments_total,
            "batches_total": self.batches_total,
            "padded_total": self.padded_total,
            "pad_fraction": self.padded_total
            / max(1, self.segments_total + self.padded_total),
            "diagnoses_total": self.diagnoses_total,
            "va_diagnoses_total": self.va_diagnoses_total,
            "urgent_packed_total": self.urgent_packed_total,
            "dropped_total": self.dropped_total,
            "wall_s": wall,
            "segments_per_s_wall": self.segments_total / wall,
            "diagnoses_per_s_wall": self.diagnoses_total / wall,
            "virtual_horizon_s": self.virtual_horizon_s,
            "segments_per_s_virtual": self.segments_total / vh,
            "queue_depth_mean": (
                self._depth_sum / self._depth_n if self._depth_n else 0.0
            ),
            "queue_depth_max": int(self._depth_max),
            "batches_by_bucket": {
                str(k): v for k, v in sorted(self._bucket_counts.items())
            },
        }
        if self._slack.count:
            out["deadline_slack_s"] = {
                # bucketed percentiles: within one log bucket of exact
                "p50": float(self._slack.quantile(0.50)),
                # tail-latency convention: the slack 99% of segments
                # exceed (1st percentile of the slack distribution) —
                # named explicitly so JSON consumers can't misread it
                # as the 99th percentile
                "worst_1pct": float(self._slack.quantile(0.01)),
                # the p99.9 analogue (slack 99.9% of segments exceed) —
                # the stream SLO's metric: worst_0p1pct >= 0 means
                # "p99.9 deadline slack is non-negative"
                "worst_0p1pct": float(self._slack.quantile(0.001)),
                "min": float(self._slack.min),  # exact
                "violations": int(self._violations),  # exact, strict < 0
                # exact (rides the exact violation count, not buckets)
                "ok_fraction": float(
                    1.0 - self._violations / self._slack.count
                ),
            }
        return out

"""Metric registry: counters, gauges, mergeable fixed-bucket histograms.

Copy of `repro.obs.registry` for the port (numpy only). One `Registry`
per process holds every metric by name, and every instrument is O(1)
memory regardless of sample count — a histogram is a fixed array of
log-spaced buckets, so p50/p99/p99.9 over a million-sample latency
stream costs O(buckets), and per-shard histograms merge by bucket-wise
addition (bit-exact: merging shard histograms equals the histogram of
the concatenated samples). `tests/test_torch_obs.py` holds every
histogram to the reference's, bucket for bucket.

A *disabled* registry hands out shared null instruments whose methods
are no-ops — the hot paths call `obs.get().registry.counter(...)`
unconditionally and pay nanoseconds, not branches, when telemetry is
off.

Bucket layouts:

  * `latency` — log-spaced positive edges, `LATENCY_LO`..`LATENCY_HI`
    seconds at `PER_DECADE` buckets per decade (relative quantile error
    bounded by one bucket ratio, 10^(1/PER_DECADE) ≈ 1.21x);
  * `signed`  — the latency edges mirrored through 0 (for deadline
    *slack*, which is negative on a violation): ...-1e-6, 0, 1e-6...
    with 0 an explicit edge so "how many samples were <= 0" is exact.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Optional

import numpy as np

LATENCY_LO = 1e-7  # 100 ns — below one python bytecode dispatch
LATENCY_HI = 1e5  # ~28 h — beyond any single run
PER_DECADE = 12


def latency_bounds(
    lo: float = LATENCY_LO, hi: float = LATENCY_HI,
    per_decade: int = PER_DECADE,
) -> np.ndarray:
    """Log-spaced finite bucket upper edges (ascending, positive)."""
    n = int(round(math.log10(hi / lo) * per_decade))
    return np.geomspace(lo, hi, n + 1)


def signed_bounds(
    lo: float = LATENCY_LO, hi: float = LATENCY_HI,
    per_decade: int = PER_DECADE,
) -> np.ndarray:
    """Symmetric signed-log edges: -latency reversed, 0, +latency."""
    pos = latency_bounds(lo, hi, per_decade)
    return np.concatenate([-pos[::-1], [0.0], pos])


_LAYOUTS = {
    "latency": latency_bounds,
    "signed": signed_bounds,
}


class Histogram:
    """Fixed-bucket histogram. `bounds` are the finite bucket upper
    edges; `counts` has `len(bounds) + 1` entries — sample x lands in
    the first bucket whose edge is >= x, or the overflow bucket past
    the last edge. Exact count/sum/min/max ride along so the summary
    never loses the extremes to bucketing."""

    __slots__ = (
        "name", "layout", "bounds", "counts", "count", "sum",
        "min", "max", "_edge_list",
    )

    def __init__(self, name: str = "", layout: str = "latency",
                 bounds: Optional[np.ndarray] = None):
        self.name = name
        self.layout = layout if bounds is None else "custom"
        self.bounds = (
            np.asarray(bounds, np.float64)
            if bounds is not None
            else _LAYOUTS[layout]()
        )
        self.counts = np.zeros(len(self.bounds) + 1, np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        # the edges as floats for `bisect`: one observation costs a
        # fraction of a microsecond instead of a numpy call's several
        self._edge_list = self.bounds.tolist()

    # -- observation --------------------------------------------------------

    def observe(self, x: float) -> None:
        x = float(x)
        # np.searchsorted(bounds, x, side="left"), NaN past the last edge
        edges = self._edge_list
        i = bisect.bisect_left(edges, x) if x == x else len(edges)
        self.counts[i] += 1
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    def observe_array(self, xs) -> None:
        xs = np.asarray(xs, np.float64).ravel()
        if xs.size == 0:
            return
        idx = np.searchsorted(self.bounds, xs, side="left")
        self.counts += np.bincount(idx, minlength=len(self.counts))
        self.count += xs.size
        self.sum += float(xs.sum())
        self.min = min(self.min, float(xs.min()))
        self.max = max(self.max, float(xs.max()))

    # -- merge --------------------------------------------------------------

    def merge(self, other: "Histogram") -> "Histogram":
        """Bucket-wise in-place merge; layouts must match exactly."""
        if len(self.bounds) != len(other.bounds) or not np.array_equal(
            self.bounds, other.bounds
        ):
            raise ValueError(
                f"histogram layout mismatch: {self.name!r} vs "
                f"{other.name!r}"
            )
        self.counts += other.counts
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    @classmethod
    def merged(cls, hists) -> "Histogram":
        hists = list(hists)
        if not hists:
            raise ValueError("nothing to merge")
        out = cls(hists[0].name, bounds=hists[0].bounds)
        out.layout = hists[0].layout
        for h in hists:
            out.merge(h)
        return out

    # -- quantiles ----------------------------------------------------------

    def _edges(self, i: int) -> tuple[float, float]:
        """(lower, upper) edge of bucket i, clamped to observed range."""
        lo = -math.inf if i == 0 else float(self.bounds[i - 1])
        hi = math.inf if i >= len(self.bounds) else float(self.bounds[i])
        return max(lo, self.min), min(hi, self.max)

    def quantile(self, q: float) -> float:
        """Rank-interpolated quantile from the buckets: O(buckets),
        error bounded by the width of the bucket holding the rank."""
        if self.count == 0:
            return math.nan
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo, hi = self._edges(i)
                frac = min(max((target - cum) / c, 0.0), 1.0)
                return lo + frac * (hi - lo)
            cum += c
        return self.max

    def count_at_or_below(self, x: float) -> int:
        """Exact when `x` is a bucket edge (e.g. 0 in the signed
        layout); otherwise rounds down to the nearest edge."""
        i = int(np.searchsorted(self.bounds, float(x), side="right"))
        return int(self.counts[:i].sum())

    def fraction_at_or_below(self, x: float) -> float:
        """SLO compliance fraction: P(sample <= x). Exact at bucket
        edges — which is why the signed layout keeps 0 explicit (the
        deadline-slack SLO asks exactly 'what fraction was < 0')."""
        if self.count == 0:
            return math.nan
        return self.count_at_or_below(x) / self.count

    # -- report -------------------------------------------------------------

    def summary(self) -> dict:
        """The shared BENCH `telemetry` histogram record."""
        empty = self.count == 0
        return {
            "count": int(self.count),
            "sum": float(self.sum),
            "min": None if empty else float(self.min),
            "max": None if empty else float(self.max),
            "mean": None if empty else float(self.sum / self.count),
            "p50": None if empty else float(self.quantile(0.50)),
            "p90": None if empty else float(self.quantile(0.90)),
            "p99": None if empty else float(self.quantile(0.99)),
            "p999": None if empty else float(self.quantile(0.999)),
            "layout": self.layout,
            "n_buckets": int(len(self.counts)),
            # sparse encoding: only occupied buckets, as
            # [bucket index, count, upper edge] triples
            "nonzero_buckets": [
                [int(i), int(c),
                 None if i >= len(self.bounds)
                 else float(self.bounds[i])]
                for i, c in enumerate(self.counts) if c
            ],
        }


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    add = inc


class Gauge:
    """Last-set value plus the high-water mark (peak) since creation —
    the pair device-memory tracking needs."""

    __slots__ = ("name", "value", "peak")

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0.0
        self.peak = -math.inf

    def set(self, v: float) -> None:
        self.value = float(v)
        if self.value > self.peak:
            self.peak = self.value


class _NullCounter:
    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    add = inc


class _NullGauge:
    __slots__ = ()
    value = 0.0
    peak = 0.0

    def set(self, v: float) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    count = 0

    def observe(self, x: float) -> None:
        pass

    def observe_array(self, xs) -> None:
        pass


NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()


class Registry:
    """Name -> instrument map. Creation is lazy and idempotent
    (`counter("x")` twice returns the same object); a disabled registry
    returns the shared null instruments without allocating."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str):
        if not self.enabled:
            return NULL_COUNTER
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str):
        if not self.enabled:
            return NULL_GAUGE
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str, layout: str = "latency"):
        if not self.enabled:
            return NULL_HISTOGRAM
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name, Histogram(name, layout)
                )
        return h

    def snapshot(self) -> dict:
        """The registry half of the shared BENCH `telemetry` schema."""
        return {
            "counters": {
                k: int(c.value) for k, c in sorted(self._counters.items())
            },
            "gauges": {
                k: {"value": g.value,
                    "peak": None if g.peak == -math.inf else g.peak}
                for k, g in sorted(self._gauges.items())
            },
            "histograms": {
                k: h.summary()
                for k, h in sorted(self._histograms.items())
            },
        }

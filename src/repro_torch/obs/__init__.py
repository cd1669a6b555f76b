"""repro_torch.obs — unified telemetry: metrics, traces, call signatures.

Port of `repro.obs`. One `Telemetry` object per process bundles the
three probes every subsystem shares:

  * `registry` — counters / gauges / mergeable log-bucket histograms
    (`obs.registry`): O(buckets) tail latency (p50/p99/p99.9) at fleet
    scale;
  * `tracer`   — structured spans with a JSONL event log and a
    Chrome/Perfetto export (`obs.trace`), virtual-time aware;
  * `probe`    — per-cell call-signature tracking, bounded step timing,
    device-memory gauges (`obs.torchprobe`).

The hot paths (the stream fleet loop and its scheduler) call `obs.get()`
each time and emit unconditionally; the **default telemetry is
disabled** and every emission is a no-op costing nanoseconds, so the
instrumentation has no off-switch to forget and no measurable tax when
off. Benchmarks enable it and attach `telemetry_section()` to their
records.

Usage:

    from repro_torch import obs

    tel = obs.configure(enabled=True)        # benchmarks
    with obs.get().span("stream/flush", bucket=32):
        ...
    obs.get().registry.histogram("stream.flush_wall_s").observe(dt)
    tel.finish("/tmp/run")   # -> /tmp/run.jsonl + /tmp/run.json
    obs.reset()              # back to the disabled default
"""

from __future__ import annotations

from repro_torch.obs.lineage import (
    assert_joined,
    critical_path,
    join_lineage,
    serve_rid,
    stream_rid,
)
from repro_torch.obs.registry import (
    NULL_COUNTER,
    NULL_GAUGE,
    NULL_HISTOGRAM,
    Counter,
    Gauge,
    Histogram,
    Registry,
    latency_bounds,
    signed_bounds,
)
from repro_torch.obs.torchprobe import (
    NULL_PROBE,
    TorchProbe,
    device_memory_bytes,
    observe_memory,
    synchronize,
    timed_call,
)
from repro_torch.obs.trace import (
    NULL_SPAN,
    NULL_TRACER,
    LazyAttr,
    Tracer,
    validate_chrome,
    validate_event,
    validate_jsonl,
)

SCHEMA_VERSION = 1


class Telemetry:
    """Registry + tracer + probe with one shared enabled flag."""

    __slots__ = ("enabled", "registry", "tracer", "probe")

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.registry = Registry(enabled=enabled)
        self.tracer = Tracer(enabled=enabled) if enabled else NULL_TRACER
        self.probe = TorchProbe(enabled=enabled) if enabled else NULL_PROBE

    # hot-path conveniences ---------------------------------------------

    def span(self, name: str, cat: str = "app", **attrs):
        return self.tracer.span(name, cat, **attrs)

    def block(self, x):
        """Wait for the CUDA stream of `x` only when telemetry is enabled
        — span durations then bound device work, while the disabled path
        never serializes the asynchronous queue."""
        if self.enabled:
            synchronize(x)
        return x

    # lifecycle ----------------------------------------------------------

    def finish(self, out_prefix: str) -> tuple[str, str]:
        """Write the JSONL event log and the Chrome/Perfetto export:
        `<out_prefix>.jsonl` + `<out_prefix>.json`. Returns the two
        paths."""
        jsonl = out_prefix + ".jsonl"
        chrome = out_prefix + ".json"
        self.tracer.write_jsonl(jsonl)
        self.tracer.export_chrome(chrome)
        return jsonl, chrome


_DISABLED = Telemetry(enabled=False)
_current = _DISABLED


def get() -> Telemetry:
    """The process-wide telemetry (disabled no-op by default)."""
    return _current


def configure(enabled: bool = True) -> Telemetry:
    """Install (and return) a fresh process-wide Telemetry. Call
    *before* constructing runners so their cells register with the
    probe."""
    global _current
    _current = Telemetry(enabled=enabled)
    return _current


def install(tel: Telemetry) -> Telemetry:
    """Re-install a previously captured Telemetry (e.g. after an A/B
    overhead measurement swapped in throwaway instances)."""
    global _current
    _current = tel
    return _current


def reset() -> None:
    """Back to the shared disabled default (test teardown)."""
    global _current
    _current = _DISABLED


def telemetry_section(tel: Telemetry | None = None) -> dict:
    """The shared BENCH `telemetry` schema, the reference's keys:

      {
        "schema_version": 1,
        "enabled": bool,
        "counters":   {name: int},
        "gauges":     {name: {"value", "peak"}},
        "histograms": {name: {count,sum,min,max,mean,
                              p50,p90,p99,p999,layout,
                              n_buckets,nonzero_buckets}},
        "recompiles": {cell name: distinct call signatures},
        "peak_device_memory_bytes": int,
      }

    Benchmarks may add an "overhead" sub-record (the stream benchmark
    records its measured enabled-vs-disabled wall delta there)."""
    tel = tel or get()
    if tel.enabled:
        observe_memory(tel.registry)
    snap = tel.registry.snapshot()
    mem = snap["gauges"].get("torch.device_bytes", {})
    return {
        "schema_version": SCHEMA_VERSION,
        "enabled": tel.enabled,
        **snap,
        "recompiles": tel.probe.cache_sizes(),
        "peak_device_memory_bytes": int(mem.get("peak") or 0),
    }


__all__ = [
    "SCHEMA_VERSION",
    "Telemetry",
    "configure",
    "get",
    "install",
    "reset",
    "telemetry_section",
    # registry
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "latency_bounds",
    "signed_bounds",
    "NULL_COUNTER",
    "NULL_GAUGE",
    "NULL_HISTOGRAM",
    # lineage
    "assert_joined",
    "critical_path",
    "join_lineage",
    "serve_rid",
    "stream_rid",
    # trace
    "LazyAttr",
    "Tracer",
    "NULL_SPAN",
    "NULL_TRACER",
    "validate_chrome",
    "validate_event",
    "validate_jsonl",
    # torchprobe
    "TorchProbe",
    "NULL_PROBE",
    "device_memory_bytes",
    "observe_memory",
    "synchronize",
    "timed_call",
]

"""PyTorch port vs JAX package on the obs core: histograms bucket for
bucket, trace export and validation, lineage ids and joins, the
`telemetry_section` schema, the torch probe, and the disabled no-op.

Both packages get the same numpy samples and the same span sequences;
histograms, summaries and joins must be identical (the port's registry,
trace and lineage are copies of the reference's).
"""

import json
import math
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import lineage as jlineage
from repro.obs import registry as jreg
from repro_torch import obs as tobs
from repro_torch.obs import lineage as tlineage
from repro_torch.obs import registry as treg
from repro_torch.obs import torchprobe


@pytest.fixture(autouse=True)
def _reset_obs():
    """Every test leaves both packages' telemetry at the disabled
    default."""
    yield
    tobs.reset()
    jobs.reset()


def _samples(layout: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.lognormal(mean=-6.0, sigma=2.5, size=500)
    if layout == "signed":
        x = x * rng.choice([-1.0, 1.0], size=x.size)
        x[:7] = 0.0  # exactly on the 0 edge
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layout", ["latency", "signed"])
def test_histogram_equals_reference_bucket_for_bucket(layout, seed):
    xs = _samples(layout, seed)
    got, want = treg.Histogram("h", layout), jreg.Histogram("h", layout)
    got.observe_array(xs[:250])
    want.observe_array(xs[:250])
    for x in xs[250:]:  # the scalar path too
        got.observe(x)
        want.observe(x)
    np.testing.assert_array_equal(got.bounds, want.bounds)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.summary() == want.summary()
    for q in (0.001, 0.01, 0.5, 0.99):
        assert got.quantile(q) == want.quantile(q)
    assert got.fraction_at_or_below(0.0) == want.fraction_at_or_below(0.0)


def test_histogram_observe_matches_the_reference_at_the_edges():
    """One observation at a time lands where the reference's does: on an
    edge, one ulp either side, zero, the infinities and NaN."""
    h_t, h_j = tobs.Histogram("x"), jobs.Histogram("x")
    edges = h_j.bounds[[0, 1, 17, len(h_j.bounds) // 2, -1]]
    xs = [0.0, -0.0, math.inf, -math.inf, math.nan]
    for e in edges:
        xs += [e, np.nextafter(e, math.inf), np.nextafter(e, -math.inf)]
    for x in xs:
        h_t.observe(x)
        h_j.observe(x)
        np.testing.assert_array_equal(h_t.counts, h_j.counts, err_msg=repr(x))


def test_histogram_merge_is_bucket_exact_and_rejects_a_layout_mismatch():
    xs = _samples("latency", 5)
    shards = np.array_split(xs, 4)
    parts = []
    for s in shards:
        h = treg.Histogram("t", "latency")
        h.observe_array(s)
        parts.append(h)
    merged = treg.Histogram.merged(parts)
    whole = treg.Histogram("t", "latency")
    whole.observe_array(xs)
    np.testing.assert_array_equal(merged.counts, whole.counts)
    assert merged.count == whole.count == xs.size
    assert merged.min == whole.min and merged.max == whole.max
    assert merged.layout == "latency"
    with pytest.raises(ValueError, match="layout mismatch"):
        treg.Histogram("a", "latency").merge(treg.Histogram("b", "signed"))
    with pytest.raises(ValueError, match="nothing to merge"):
        treg.Histogram.merged([])


def _emit(pkg):
    """The same span sequence through either package's telemetry."""
    tel = pkg.configure(enabled=True)
    tel.registry.counter("x.total").inc(3)
    tel.registry.gauge("x.depth").set(2.0)
    tel.registry.histogram("x.lat_s").observe(1e-3)
    with tel.span("stream/flush", cat="stream", bucket=32, v_ts_s=1.5,
                  v_dur_s=0.25, request_ids=["stream:1:0", "stream:2:0"]):
        with tel.span("stream/classify", cat="stream",
                      request_ids=["stream:1:0", "stream:2:0"]):
            pass
    tel.tracer.instant("stream/enqueue", cat="stream",
                       request_id=pkg.stream_rid(1, 0), v_ts_s=1.0)
    tel.tracer.counter("queue_depth", 3.0, cat="stream")
    return tel


def test_trace_roundtrips_through_jsonl_and_chrome(tmp_path):
    tel = _emit(tobs)
    jsonl, chrome = tel.finish(str(tmp_path / "t"))
    assert tobs.validate_jsonl(jsonl) == 4
    # 4 events + 2 process-name metadata + 1 virtual-time mirror
    assert tobs.validate_chrome(chrome) == 7
    # the reference's validators accept the port's files, and back
    assert jobs.validate_jsonl(jsonl) == 4
    assert jobs.validate_chrome(chrome) == 7
    with open(jsonl) as f:
        events = [json.loads(line) for line in f]
    assert events == json.loads(json.dumps(tel.tracer.events()))
    with open(chrome) as f:
        doc = json.load(f)
    virt = [e for e in doc["traceEvents"]
            if e.get("pid") == 1 and e.get("ph") == "X"]
    assert len(virt) == 1
    assert virt[0]["ts"] == pytest.approx(1.5e6)
    assert virt[0]["dur"] == pytest.approx(0.25e6)
    for bad in ({**events[0], "type": "nope"}, {**events[0], "ts_us": -1.0}):
        with pytest.raises(ValueError):
            tobs.validate_event(bad)


def test_deferred_events_join_the_trace_when_read(tmp_path):
    """Spans a hot loop timed itself (`record`), buffered events drained
    on reading (`defer`) and lazy attributes: built when the events are
    read, each once, with unique ids and the given parents."""
    tel = tobs.configure(enabled=True)
    buffered, resolved = [], []

    class Ids(tobs.LazyAttr):
        def resolve(self):
            resolved.append(1)
            return ["stream:1:0", "stream:2:0"]

    t = time.perf_counter()
    buffered.append(("stream/enqueue", "stream", t, None, 0, 7, {"v_ts_s": 1.0}))

    def drain():
        out = list(buffered)
        buffered.clear()
        return out

    tel.tracer.defer(drain)
    flush = tel.tracer.record("stream/flush", "stream", t, t + 2e-3, 0,
                              request_ids=Ids())
    tel.tracer.record("stream/vote", "stream", t + 1e-3, t + 2e-3, flush)
    events = tel.tracer.events()
    assert tel.tracer.events() == events and not buffered and resolved == [1]
    by_name = {e["name"]: e for e in events}
    assert by_name["stream/enqueue"]["type"] == "instant"
    assert by_name["stream/enqueue"]["dur_us"] == 0.0
    assert by_name["stream/enqueue"]["tid"] == 7
    assert by_name["stream/flush"]["dur_us"] == pytest.approx(2e3)
    assert by_name["stream/flush"]["attrs"]["request_ids"] == [
        "stream:1:0", "stream:2:0"]
    assert by_name["stream/vote"]["parent_id"] == flush
    assert len({e["span_id"] for e in events}) == 3
    jsonl, chrome = tel.finish(str(tmp_path / "t"))
    assert tobs.validate_jsonl(jsonl) == 3
    tobs.validate_chrome(chrome)
    tobs.reset()
    assert tobs.get().tracer.record("x", "app", t, t, 0) == 0


def test_lineage_joins_like_the_reference():
    assert tobs.stream_rid(7, 3) == jobs.stream_rid(7, 3) == "stream:7:3"
    assert tobs.serve_rid(4) == jobs.serve_rid(4)
    events = _emit(tobs).tracer.events()
    got, want = tlineage.join(events), jlineage.join(events)
    assert sorted(got) == sorted(want) == ["stream:1:0", "stream:2:0"]
    for rid in got:
        assert [h.name for h in got[rid]] == [h.name for h in want[rid]]
        assert (tlineage.critical_path(got[rid])
                == jlineage.critical_path(want[rid]))
    assert tlineage.summarize(events) == jlineage.summarize(events)
    tobs.assert_joined(events, min_hops=2, expect_prefix="stream:")
    with pytest.raises(AssertionError):
        tobs.assert_joined(events, min_hops=4)


def test_span_stack_is_thread_local():
    tel = tobs.configure(enabled=True)
    barrier = threading.Barrier(2)

    def worker(name: str):
        with tel.span(f"outer/{name}", cat="t"):
            barrier.wait(timeout=10)
            with tel.span(f"inner/{name}", cat="t"):
                barrier.wait(timeout=10)

    threads = [threading.Thread(target=worker, args=(n,)) for n in "ab"]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    ev = {e["name"]: e for e in tel.tracer.events()}
    for n in "ab":
        outer, inner = ev[f"outer/{n}"], ev[f"inner/{n}"]
        assert outer["parent_id"] == 0
        assert inner["parent_id"] == outer["span_id"]


@pytest.mark.parametrize("enabled", [True, False])
def test_telemetry_section_keys_equal_the_reference(enabled):
    tel_j = _emit(jobs) if enabled else jobs.get()
    tel_t = _emit(tobs) if enabled else tobs.get()
    if enabled:
        tel_j.probe.track("x.cell", jax.jit(lambda v: v + 1))(jnp.ones(3))
        tel_t.probe.track("x.cell", lambda v: v + 1)(torch.ones(3))
    got, want = tobs.telemetry_section(tel_t), jobs.telemetry_section(tel_j)
    assert list(got) == list(want)
    assert got["schema_version"] == want["schema_version"] == 1
    assert got["enabled"] is want["enabled"] is enabled
    for key in ("counters", "histograms"):
        assert got[key] == want[key]
    assert got["recompiles"] == want["recompiles"]
    # no card here: the allocator holds nothing
    assert got["peak_device_memory_bytes"] == 0


def test_probe_counts_distinct_signatures():
    probe = torchprobe.TorchProbe()
    cell = probe.track("stream.classify.twin", lambda x: x.sum())
    for b in (8, 16, 8, 16):
        cell(torch.zeros((b, 4)))
    snap = probe.snapshot()
    assert snap == {"stream.classify.twin": 2}
    assert probe.cells()["stream.classify.twin"] is cell
    cell(torch.zeros((8, 4)))
    assert probe.new_misses(snap) == {}
    cell(torch.zeros((8, 4), dtype=torch.float64))  # a new dtype
    assert probe.new_misses(snap) == {"stream.classify.twin": 1}
    # disabled probes hand the callable back untouched
    f = lambda x: x  # noqa: E731
    assert tobs.NULL_PROBE.track("a", f) is f
    assert torchprobe.TorchProbe(enabled=False).track("a", f) is f
    assert tobs.device_memory_bytes() == 0
    h = treg.Histogram("t")
    assert torch.equal(tobs.timed_call(h, torch.ones, 3), torch.ones(3))
    assert h.count == 1


def test_disabled_telemetry_is_noop():
    tel = tobs.get()
    assert not tel.enabled
    assert tel.registry.counter("a") is tel.registry.counter("b")
    assert tel.registry.snapshot() == {
        "counters": {}, "gauges": {}, "histograms": {}
    }
    x = torch.ones(2)
    assert tel.block(x) is x
    assert tel.tracer.events() == []
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        tel.registry.counter("stream.enqueued_total").inc()
        tel.registry.histogram("stream.flush_wall_s").observe(1e-3)
        with tel.span("stream/flush", cat="stream"):
            pass
    per_emission_ns = (time.perf_counter() - t0) / (3 * n) * 1e9
    # the reference's bound (tests/test_obs.py)
    assert per_emission_ns < 2_000, per_emission_ns

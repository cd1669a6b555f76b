"""PyTorch port vs JAX package on the streaming fleet: per-patient
segments, sources, the scheduler, the vote, the metrics and the fleet
loop as a whole, plus the port's boundaries (no jax, no silent CPU
fallback).

The arrival process, the scheduler and the metrics are numpy in both
packages and must agree exactly. The vote must be identical on seeded
numpy batches. The port cannot reproduce jax's threefry, so its
per-patient segments are held to properties; the fleet runs are fed the
reference's segment arrays for the same (patient, seq). Logits are held
within rtol = atol = 2e-4 of the reference's (tests/test_stream.py's
twin-vs-reference tolerance); counts, diagnoses and latencies must be
identical.
"""

import dataclasses
import functools
import os
import statistics
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import CPU, n, np_params, t

from repro.core import compiler as jc
from repro.core import perf_model as jperf
from repro.core import spe as jspe
from repro.core import vadetect as jva
from repro import obs as jobs
from repro.obs import lineage as jlineage
from repro.stream import fleet as jfleet
from repro.stream import metrics as jmetrics
from repro.stream import runner as jrunner
from repro.stream import scheduler as jsched
from repro.stream import sources as jsources
from repro.stream import vote as JV
from repro_torch import convert, obs
from repro_torch.benchmarks import stream_throughput
from repro_torch.core import compiler as tc
from repro_torch.data import iegm as tiegm
from repro_torch.examples import stream_fleet
from repro_torch.stream import fleet as tfleet
from repro_torch.stream import metrics as tmetrics
from repro_torch.stream import runner as trunner
from repro_torch.stream import scheduler as tsched
from repro_torch.stream import sources as tsources
from repro_torch.stream import vote as TV

REPO = Path(__file__).resolve().parents[1]
RTOL = ATOL = 2e-4  # tests/test_stream.py:313


@pytest.fixture(autouse=True)
def _reset_obs():
    yield
    obs.reset()


@functools.lru_cache(maxsize=None)
def _programs():
    """(jax program, the same program in the port) at full VA width. The
    port compiles (the JAX compiler's equal output is held in
    tests/test_torch_serve.py, and takes seconds longer at this width);
    the reference gets the port's arrays."""
    cfg = jva.VAConfig()
    tree = np_params(cfg.layers, 21)
    prog_t = tc.compile_model(convert.params_from_numpy(tree, device=CPU))
    layers = {
        name: jspe.CompiledLayer(
            values_q=jnp.asarray(n(l.values_q)), select=jnp.asarray(n(l.select)),
            scale=jnp.asarray(n(l.scale)),
            packed_planes=jnp.asarray(n(l.packed_planes)), bits=l.bits,
            group_size=l.group_size, keep=l.keep, k_dense=l.k_dense,
            sparse=l.sparse)
        for name, l in prog_t.layers.items()
    }
    meta = jva.layer_shapes(cfg)
    report = jperf.chip_report([
        jperf.LayerWorkload(**{k: m[k] for k in (
            "name", "c_in", "c_out", "ksize", "t_out", "macs", "bits",
            "keep_frac", "sparse")})
        for m in meta
    ])
    prog_j = jc.AcceleratorProgram(
        layers=layers,
        biases={k: jnp.asarray(n(b)) for k, b in prog_t.biases.items()},
        layer_meta=meta, report=report,
    )
    assert dataclasses.asdict(prog_t.report) == dataclasses.asdict(report)
    return prog_j, prog_t


# ---------------------------------------------------------------------------
# per-patient segments (data.iegm)
# ---------------------------------------------------------------------------


def _fresh_segment_batch(*args, **kwargs):
    """`segment_batch` with the row and label memos emptied first, so
    every row is drawn anew."""
    tiegm._segment_row.cache_clear()
    tiegm._label_draw.cache_clear()
    return tiegm.segment_batch(*args, **kwargs)


def test_segment_rows_are_keyed_by_seed_patient_seq():
    a = _fresh_segment_batch(0, [3, 9, 4, 9], [2, 0, 7, 5], device="cpu")
    b = _fresh_segment_batch(0, [9], [0], device="cpu")
    c = _fresh_segment_batch(0, [4, 9, 3], [7, 0, 2], device="cpu")
    # bit-identical whatever the batch's composition or order
    assert torch.equal(a["signal"][1], b["signal"][0])
    assert torch.equal(a["signal"][0], c["signal"][2])
    assert torch.equal(a["signal"][2], c["signal"][0])
    # the label is the patient's, whatever the seq
    assert a["label"][1] == a["label"][3] == b["label"][0]
    assert not torch.equal(a["signal"][1], a["signal"][3])
    assert not torch.equal(
        b["signal"][0], tiegm.segment_batch(1, [9], [0], device="cpu")["signal"][0]
    )
    assert a["signal"].shape == (4, 512) and a["signal"].dtype == torch.float32
    assert a["label"].dtype == torch.int32
    assert bool(torch.isfinite(a["signal"]).all())
    # normalized per record (the front end's AGC)
    torch.testing.assert_close(a["signal"].std(dim=1, correction=0),
                               torch.ones(4), rtol=1e-4, atol=1e-4)
    empty = tiegm.segment_batch(0, [], [], device="cpu")
    assert empty["signal"].shape == (0, 512)


def test_stream_segments_restart_and_agree():
    it_a = tiegm.stream_segments(7, seed=3, device="cpu")
    it_b = tiegm.stream_segments(7, seed=3, device="cpu")
    first = [next(it_a) for _ in range(3)]
    for seg in first:
        tiegm._segment_row.cache_clear()
        other = next(it_b)
        assert seg["seq"] == other["seq"] and seg["label"] == other["label"]
        assert torch.equal(seg["signal"], other["signal"])
    tiegm._segment_row.cache_clear()
    restarted = next(tiegm.stream_segments(7, seed=3, start=2, device="cpu"))
    assert restarted["seq"] == 2
    assert torch.equal(restarted["signal"], first[2]["signal"])
    row = _fresh_segment_batch(3, [7], [1], device="cpu")["signal"][0]
    assert torch.equal(row, first[1]["signal"])


def test_memoized_rows_equal_fresh_draws():
    pats, seqs = [2, 8, 2, 11], [0, 3, 1, 0]
    fresh = _fresh_segment_batch(4, pats, seqs, va_fraction=0.5, device="cpu")
    memo = tiegm.segment_batch(4, pats, seqs, va_fraction=0.5, device="cpu")
    assert tiegm._segment_row.cache_info().hits == len(pats)
    assert torch.equal(memo["signal"], fresh["signal"])
    assert torch.equal(memo["label"], fresh["label"])
    # a caller's batch is its own copy: writing it leaves the memo intact
    memo["signal"].zero_()
    again = tiegm.segment_batch(4, pats, seqs, va_fraction=0.5, device="cpu")
    assert torch.equal(again["signal"], fresh["signal"])


@pytest.mark.parametrize("va_fraction", [0.05, 0.5])
def test_patient_labels_hold_the_va_share(va_fraction):
    tiegm._label_draw.cache_clear()
    labels = tiegm.patient_labels(0, np.arange(4000), va_fraction)
    # 4 standard deviations of a binomial share over 4000 patients
    sd = (va_fraction * (1 - va_fraction) / 4000) ** 0.5
    assert abs(float(labels.float().mean()) - va_fraction) < 4 * sd
    tiegm._label_draw.cache_clear()
    assert torch.equal(labels, tiegm.patient_labels(0, np.arange(4000), va_fraction))
    pats = np.array([5, 17, 5, 99])
    batch = tiegm.segment_batch(0, pats, [0, 1, 2, 3], va_fraction=va_fraction,
                                device="cpu")
    assert torch.equal(batch["label"], tiegm.patient_labels(0, pats, va_fraction))


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------


def test_ring_buffer_and_virtual_time_match_the_reference():
    rb_t, rb_j = tsources.RingBuffer(2, 8), jsources.RingBuffer(2, 8)
    for chunk in (np.arange(5), np.arange(5, 11), np.arange(11, 40)):
        got, want = rb_t.push(chunk), rb_j.push(chunk)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert rb_t.fill == rb_j.fill
    assert tsources.SEGMENT_PERIOD_S == jsources.SEGMENT_PERIOD_S
    big = 2.0**50
    for now, target in ((1.0, 2.5), (big, big + 1e-6), (big, big)):
        assert (tsources.advance_virtual_time(now, target)
                == jsources.advance_virtual_time(now, target))


@pytest.mark.parametrize("jitter,dropout,seed", [
    (0.0, 0.0, 0), (0.05, 0.0, 11), (0.3, 0.2, 5), (0.02, 0.1, 3),
])
def test_arrivals_equal_the_reference(jitter, dropout, seed):
    kw = dict(n_patients=37, seed=seed, va_fraction=0.1,
              jitter_frac=jitter, dropout=dropout)
    got = tsources.FleetSource(tsources.SourceConfig(**kw)).arrivals(6)
    want = jsources.FleetSource(jsources.SourceConfig(**kw)).arrivals(6)
    assert [tuple(vars(r).values()) for r in got] == [
        tuple(vars(r).values()) for r in want
    ]
    assert len(got) < 37 * 6 if dropout else len(got) == 37 * 6


def test_check_refs_matches_the_reference():
    mk_t = lambda p, s, a, d: tsources.SegmentRef(p, s, a, d)  # noqa: E731
    mk_j = lambda p, s, a, d: jsources.SegmentRef(p, s, a, d)  # noqa: E731
    cases = [
        [(0, 0, 0.0, 1.0), (1, 0, 0.5, 2.0)],  # fine
        [(3, 0, 0.0, 1.0)],  # patient out of range
        [(0, 0, 0.0, 1.0), (0, 0, 0.5, 2.0)],  # duplicate identity
        [(0, 0, 1.0, 1.0)],  # deadline not after arrival
        [(0, 0, 1.0, 2.0), (1, 0, 0.5, 2.0)],  # unsorted
    ]
    for case in cases:
        outcome = []
        for mk, check in ((mk_t, tsources.check_refs), (mk_j, jsources.check_refs)):
            try:
                check([mk(*r) for r in case], 2)
                outcome.append("ok")
            except ValueError as err:
                outcome.append(str(err))
        assert outcome[0] == outcome[1], case


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

_BATCH_FIELDS = ("patients", "seqs", "arrivals", "deadlines", "priorities",
                 "valid", "bucket", "n_valid", "formed_at_s")


def _random_refs(mod, n_patients, n_segments, seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_segments):
        p = int(rng.integers(n_patients))
        a = float(rng.uniform(0, 10))
        out.append(mod.SegmentRef(patient=p, seq=k, arrival_s=a,
                                  deadline_s=a + 2.048))
    return out


def _arrival_refs(mod, n_patients, seed):
    cfg = mod.SourceConfig(n_patients=n_patients, seed=seed,
                           jitter_frac=0.05, dropout=0.1)
    return mod.FleetSource(cfg).arrivals(6)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("refs", ["random", "arrivals"])
def test_scheduler_packs_the_reference_batches(refs, seed):
    """On the same refs, urgency updates (preemption) and clock, the
    port packs the reference's batches, field for field."""
    rng = np.random.default_rng(seed)
    n_patients = int(rng.integers(2, 12))
    make = (_arrival_refs if refs == "arrivals"
            else lambda mod, p, s: _random_refs(mod, p, int(rng.integers(1, 80)), s))
    refs_j = make(jsources, n_patients, seed)
    refs_t = [tsources.SegmentRef(**vars(r)) for r in refs_j]
    n_segments = len(refs_j)
    cfg_kw = dict(buckets=(4, 8, 16), max_wait_s=0.256)
    pair = [(tsched.MicroBatchScheduler(tsched.SchedulerConfig(**cfg_kw), n_patients),
             refs_t),
            (jsched.MicroBatchScheduler(jsched.SchedulerConfig(**cfg_kw), n_patients),
             refs_j)]
    i = 0
    while i < n_segments or pair[0][0].ready():
        take = int(rng.integers(1, 9))
        urgent = rng.random(n_patients) < 0.3
        marks = rng.integers(0, n_patients, int(rng.integers(0, 3)))
        now = float(rng.uniform(0, 20))
        for sched, refs in pair:
            sched.extend(refs[i:i + take])
            sched.set_urgent(urgent)
            sched.mark_urgent(marks)  # preemption, also when empty
        i = min(i + take, n_segments)
        assert pair[0][0].should_flush(now) == pair[1][0].should_flush(now)
        batches = [s.next_batch(now) if s.ready() else None for s, _ in pair]
        got, want = batches
        assert (got is None) == (want is None)
        if got is None:
            continue
        for f in _BATCH_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
            assert np.asarray(getattr(got, f)).dtype == np.asarray(getattr(want, f)).dtype
        assert pair[0][0].oldest_arrival() == pair[1][0].oldest_arrival()
    s_t, s_j = pair[0][0], pair[1][0]
    assert (s_t.enqueued_total, s_t.packed_total) == (s_j.enqueued_total, s_j.packed_total)


# ---------------------------------------------------------------------------
# vote
# ---------------------------------------------------------------------------


def _vote_batches(n_patients, n_batches, bucket, seed):
    """Seeded batches with duplicate patients, padding rows and rows that
    would straddle a 6-segment window masked out, as the scheduler
    guarantees (tests/test_stream.py's construction)."""
    rng = np.random.default_rng(seed)
    count = np.zeros(n_patients, np.int64)
    out = []
    for _ in range(n_batches):
        patients = rng.integers(0, n_patients, bucket).astype(np.int32)
        preds = rng.integers(0, 2, bucket).astype(np.int32)
        valid = np.arange(bucket) < int(rng.integers(1, bucket + 1))
        in_batch = np.zeros(n_patients, np.int64)
        for i in range(bucket):
            if not valid[i]:
                continue
            p = patients[i]
            if in_batch[p] >= JV.VOTE_SEGMENTS - count[p] % JV.VOTE_SEGMENTS:
                valid[i] = False
            else:
                in_batch[p] += 1
        count += in_batch
        out.append((patients, preds, valid))
    return out


@pytest.mark.parametrize("n_patients,bucket,seed", [
    (2, 8, 0), (3, 16, 1), (5, 4, 2), (9, 8, 3), (4, 32, 4),
])
def test_vote_update_is_the_reference_update(n_patients, bucket, seed):
    st_t, st_j = TV.init(n_patients, device="cpu"), JV.init(n_patients)
    emitted = 0
    for patients, preds, valid in _vote_batches(n_patients, 12, bucket, seed):
        st_t, *out_t = TV.update(st_t, patients, preds, valid)
        st_j, *out_j = JV.update(st_j, jnp.asarray(patients),
                                 jnp.asarray(preds), jnp.asarray(valid))
        for name, g, w in zip(("ring", "count", "last_positive"), st_t, st_j):
            assert n(g).dtype == np.int32, name
            np.testing.assert_array_equal(n(g), n(w), err_msg=name)
        for name, g, w in zip(("emit", "diagnosis", "urgent"), out_t, out_j):
            np.testing.assert_array_equal(n(g), n(w), err_msg=name)
            assert n(g).dtype == n(w).dtype, name
        emitted += int(n(out_t[0]).sum())
    assert emitted > 0  # the batches crossed vote-window boundaries


def test_vote_duplicate_rows_fill_consecutive_slots_and_ties_go_to_va():
    state = TV.init(2, device="cpu")
    state, emit, diag, urgent = TV.update(
        state, np.array([0, 0, 0, 1]), np.array([1, 0, 1, 1]),
        np.array([True, True, True, True]))
    np.testing.assert_array_equal(n(state.ring[0, :3]), [1, 0, 1])
    assert n(state.count).tolist() == [3, 1]
    assert n(urgent).tolist() == [True, True] and not bool(emit[0])
    # three more for patient 0 (one positive): a 3/6 tie votes VA
    state, emit, diag, _ = TV.update(
        state, np.array([0, 0, 0, 0]), np.array([0, 0, 1, 1]),
        np.array([True, True, True, False]))
    assert bool(emit[0]) and int(diag[0]) == 1 and int(state.count[0]) == 6


def test_metrics_summary_matches_the_reference():
    rng = np.random.default_rng(4)
    got, want = tmetrics.FleetMetrics(), jmetrics.FleetMetrics()
    for m in (got, want):
        m.start_clock()
    for k in range(20):
        kw = dict(bucket=16, n_valid=int(rng.integers(1, 17)),
                  n_urgent=int(rng.integers(0, 3)),
                  slack_s=rng.normal(0.5, 1.0, int(rng.integers(1, 17))),
                  queue_depth=int(rng.integers(0, 50)),
                  completion_s=float(k))
        got.observe_batch(**kw)
        want.observe_batch(**kw)
        got.observe_diagnoses(k % 3, k % 2)
        want.observe_diagnoses(k % 3, k % 2)
    wall = ("wall_s", "segments_per_s_wall", "diagnoses_per_s_wall")
    s_t, s_j = got.summary(), want.summary()
    assert list(s_t) == list(s_j)
    assert ({k: v for k, v in s_t.items() if k not in wall}
            == {k: v for k, v in s_j.items() if k not in wall})


# ---------------------------------------------------------------------------
# the slice as a whole: simulate in both packages
# ---------------------------------------------------------------------------

_FLEET = dict(n_patients=12, segments_per_patient=6, buckets=(4, 16),
              va_fraction=0.4, jitter_frac=0.05, seed=11)
_WALL = ("wall_s", "segments_per_s_wall", "diagnoses_per_s_wall")


def _feed_reference_signals(monkeypatch):
    """The port's FleetSource hands out the reference's arrays for the
    same (patient, seq)."""

    def signals(self, patients, seqs):
        ref = jsources.FleetSource(jsources.SourceConfig(**vars(self.cfg)))
        out = ref.signals(np.asarray(patients), np.asarray(seqs))
        return {"signal": t(out["signal"]), "label": t(out["label"])}

    def labels(self, patients):
        ref = jsources.FleetSource(jsources.SourceConfig(**vars(self.cfg)))
        return t(ref.labels(np.asarray(patients)))

    monkeypatch.setattr(tsources.FleetSource, "signals", signals)
    monkeypatch.setattr(tsources.FleetSource, "labels", labels)


class _RecordingRef(jrunner.FleetRunner):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.seen = []

    def classify(self, signals):
        self.seen.append(np.array(signals))
        return super().classify(signals)


def _same_counts(got: dict, want: dict, buckets) -> None:
    m_t, m_j = got["metrics"], want["metrics"]
    assert list(m_t) == list(m_j)
    assert ({k: v for k, v in m_t.items() if k not in _WALL}
            == {k: v for k, v in m_j.items() if k not in _WALL})
    assert m_t["dropped_total"] == 0
    assert got["jit_cache_misses"] == want["jit_cache_misses"] == len(buckets)
    assert got["accuracy"] == want["accuracy"]
    assert got["chip"] == pytest.approx(want["chip"])
    assert list(got) == list(want)


@pytest.mark.parametrize("path", ["twin", "kernel"])
def test_fleet_matches_the_reference(monkeypatch, path):
    prog_j, prog_t = _programs()
    _feed_reference_signals(monkeypatch)
    ref_runner = _RecordingRef(prog_j, path="twin")
    want = jfleet.simulate(jfleet.FleetConfig(**_FLEET), runner=ref_runner)
    obs.configure(enabled=True)
    runner = trunner.FleetRunner(prog_t, path=path, device="cpu", record=True)
    got = tfleet.simulate(tfleet.FleetConfig(**_FLEET, path=path), runner=runner)
    _same_counts(got, want, _FLEET["buckets"])
    # the same buckets in the same order, bit for bit, and their logits
    assert len(runner.recorded) == len(ref_runner.seen)
    weights = jrunner.twin_weights(prog_j)
    for (x, logits), x_ref in zip(runner.recorded, ref_runner.seen):
        x, logits = n(x), n(logits)
        np.testing.assert_array_equal(x, x_ref)
        want_logits = np.asarray(
            jrunner._twin_logits(weights, prog_j.layer_meta, jnp.asarray(x)))
        np.testing.assert_allclose(logits, want_logits, rtol=RTOL, atol=ATOL)
    # every bucket shape reached the tracked classify cell once
    assert obs.get().probe.cache_sizes()[f"stream.classify.{path}"] == 2


def _encode(patients, seqs):
    """Rows that carry their own (patient, seq) in the first two samples."""
    sig = np.zeros((len(patients), 512), np.float32)
    sig[:, 0], sig[:, 1] = patients, seqs
    return sig


class _StubPort(trunner.FleetRunner):
    def __init__(self, program, preds):
        super().__init__(program, path="twin", device="cpu")
        self.preds = preds

    def classify(self, signals):
        x = np.asarray(signals)
        self._shapes_seen.add(x.shape[0])
        return torch.tensor([self.preds.get((int(p), int(s)), 0)
                             for p, s in x[:, :2]], dtype=torch.int32)


class _StubRef(jrunner.FleetRunner):
    def __init__(self, program, preds):
        super().__init__(program, path="twin")
        self.preds = preds

    def classify(self, signals):
        x = np.asarray(signals)
        self._shapes_seen.add(x.shape[0])
        return jnp.asarray([self.preds.get((int(p), int(s)), 0)
                            for p, s in x[:, :2]], jnp.int32)

    def jit_cache_misses(self):
        return len(self._shapes_seen)


def _stub_runners(monkeypatch, fleet):
    """Stub runners over the reference's own twin-path predictions per
    (patient, seq), for the reference and the port, with both packages'
    sources feeding rows that carry their (patient, seq)."""
    prog_j, prog_t = _programs()
    cfg = jsources.SourceConfig(
        n_patients=fleet["n_patients"], seed=fleet["seed"],
        va_fraction=fleet["va_fraction"])
    src = jsources.FleetSource(cfg)
    pats = np.repeat(np.arange(fleet["n_patients"]), 6)
    seqs = np.tile(np.arange(6), fleet["n_patients"])
    # the reference fleet's twin path
    logits = jrunner._twin_logits(jrunner.twin_weights(prog_j),
                                  prog_j.layer_meta,
                                  src.signals(pats, seqs)["signal"])
    preds = dict(zip(zip(pats.tolist(), seqs.tolist()),
                     np.asarray(jnp.argmax(logits, -1)).tolist()))
    labels = np.asarray(src.labels(np.arange(fleet["n_patients"])))

    monkeypatch.setattr(tsources.FleetSource, "signals",
                        lambda self, p, s: {"signal": t(_encode(p, s))})
    monkeypatch.setattr(tsources.FleetSource, "labels",
                        lambda self, p: t(labels[np.asarray(p)]))
    monkeypatch.setattr(jsources.FleetSource, "signals",
                        lambda self, p, s: {"signal": jnp.asarray(_encode(p, s))})
    return _StubRef(prog_j, preds), _StubPort(prog_t, preds)


@pytest.mark.parametrize("fleet", [
    _FLEET,
    dict(_FLEET, dropout=0.2, buckets=(4, 8, 16), seed=5),
])
def test_fleet_loop_is_the_reference_loop(monkeypatch, fleet):
    """With the reference's own predictions per (patient, seq) behind a
    stub runner in both packages, the loop's diagnoses and latencies are
    identical: float order is out of the picture."""
    ref_runner, port_runner = _stub_runners(monkeypatch, fleet)
    kw = dict(collect_diagnoses=True, collect_latency=True)
    want = jfleet.simulate(jfleet.FleetConfig(**fleet), runner=ref_runner, **kw)
    got = tfleet.simulate(tfleet.FleetConfig(**fleet), runner=port_runner, **kw)
    _same_counts(got, want, fleet["buckets"])
    assert got["diagnoses"] == want["diagnoses"]
    assert len(got["diagnoses"]) == got["metrics"]["diagnoses_total"] > 0
    assert list(got["latency"]) == list(want["latency"])
    for key, arr in want["latency"].items():
        assert got["latency"][key].dtype == arr.dtype, key
        np.testing.assert_array_equal(got["latency"][key], arr, err_msg=key)


def test_fleet_trace_joins_like_the_reference(monkeypatch, tmp_path):
    """With telemetry on in both packages, every segment's lineage
    (enqueue -> pack -> flush -> classify -> vote) has the reference's
    hops with the reference's virtual times, the counters agree, and
    the trace (its enqueue instants and request ids built when read)
    passes the JSONL and Chrome validators."""
    ref_runner, port_runner = _stub_runners(monkeypatch, _FLEET)
    jtel = jobs.configure(enabled=True)
    try:
        jfleet.simulate(jfleet.FleetConfig(**_FLEET), runner=ref_runner)
    finally:
        jobs.reset()
    tel = obs.configure(enabled=True)
    tfleet.simulate(tfleet.FleetConfig(**_FLEET), runner=port_runner)
    want = jlineage.join(jtel.tracer.events())
    got = obs.lineage.join(tel.tracer.events())
    assert len(got) == _FLEET["n_patients"] * 6
    assert set(got) == set(want)
    for rid, hops in want.items():
        assert [h.name for h in got[rid]] == [h.name for h in hops], rid
        assert [h.v_ts_s for h in got[rid]] == [h.v_ts_s for h in hops], rid
    obs.assert_joined(tel.tracer.events(), min_hops=5)
    assert (tel.registry.snapshot()["counters"]
            == jtel.registry.snapshot()["counters"])
    jsonl, chrome = tel.finish(str(tmp_path / "fleet"))
    assert obs.validate_jsonl(jsonl) == len(tel.tracer.events())
    obs.validate_chrome(chrome)


# ---------------------------------------------------------------------------
# entry points: the example, the benchmark, their boundaries
# ---------------------------------------------------------------------------


def test_stream_fleet_example_runs_on_the_cpu():
    out = stream_fleet.main(device="cpu", path="kernel", patients=8)
    m = out["metrics"]
    assert m["segments_total"] == 48 and m["dropped_total"] == 0
    assert m["diagnoses_total"] == 8
    assert out["jit_cache_misses"] == 3
    assert out["config"]["buckets"] == [32, 128, 512]


def test_stream_throughput_pieces_run_on_the_cpu():
    _, prog_t = _programs()
    cell = stream_throughput.run_cell(prog_t, patients=8, segments=2,
                                      bucket=8, device="cpu")
    assert cell["segments_total"] == 16 and cell["dropped_total"] == 0
    assert cell["jit_cache_misses"] == 1
    saved = obs.configure(enabled=True)
    over = stream_throughput.measure_overhead(
        prog_t, patients=8, segments=2, reps=2, max_reps=2, device="cpu")
    assert obs.get() is saved
    assert over["overhead_ratio"] > 0 and over["reps"] == 2
    for arm in ("disabled", "enabled", "disabled_again"):
        assert len(over[f"{arm}_walls_s"]) == 2
    d, e, a = (over[f"{arm}_walls_s"]
               for arm in ("disabled", "enabled", "disabled_again"))
    # paired: the median over reps of enabled / mean(disabled, again)
    assert over["overhead_ratio"] == pytest.approx(statistics.median(
        e_i / ((d_i + a_i) / 2) for d_i, e_i, a_i in zip(d, e, a)))
    assert over["noise_spread"] == pytest.approx(abs(statistics.median(
        a_i / d_i for d_i, a_i in zip(d, a)) - 1))
    lo, hi = over["ratio_bounds"]
    assert lo <= over["overhead_ratio"] <= hi
    floor = stream_throughput.wall_floor
    assert over["floor_ratio"] == pytest.approx(floor(e) / floor(d + a))
    bounds = stream_throughput.median_bounds
    assert bounds([3.0, 1.0, 2.0]) == (1.0, 3.0)
    assert bounds([float(i) for i in range(100)]) == (37.0, 62.0)
    assert floor([5.0, 1.0, 3.0]) == 3.0 and floor([4.0, 2.0]) == 3.0
    assert floor([float(i) for i in range(36, 0, -1)]) == 3.5  # fastest 6
    rec = {"cells": [cell], "device": {"type": "cpu"},
           "scaling_largest_bucket": {"devices_lo": 1, "devices_hi": 1,
                                      "modeled_speedup": 1.0},
           "realtime_1000_patients": {"dropped_total": 0,
                                      "realtime_factor": 1.5},
           "telemetry": {**obs.telemetry_section(), "overhead": over}}
    with pytest.raises(AssertionError):  # nothing was classified
        stream_throughput.check(rec)
    stream_fleet.run(device="cpu", patients=2)  # under enabled telemetry
    rec["telemetry"] = {**obs.telemetry_section(),
                        "overhead": {**over, "resolvable": False}}
    stream_throughput.check(rec)
    # the < 3% check holds wherever the A/A control resolves the ratio
    for ratio, ok in ((1.029, True), (1.031, False)):
        rec["telemetry"]["overhead"] = {**over, "resolvable": True,
                                        "overhead_ratio": ratio}
        if ok:
            stream_throughput.check(rec)
        else:
            with pytest.raises(AssertionError):
                stream_throughput.check(rec)
    rec["telemetry"]["overhead"] = over
    rec["realtime_1000_patients"]["realtime_factor"] = 0.5
    with pytest.raises(AssertionError):
        stream_throughput.check(rec)


@pytest.mark.parametrize("entry", ["simulate", "example", "benchmark",
                                   "vote", "segments"])
def test_default_device_raises_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    calls = {
        "simulate": lambda: tfleet.simulate(tfleet.FleetConfig(n_patients=2)),
        "example": lambda: stream_fleet.run(patients=2),
        "benchmark": lambda: stream_throughput.run(smoke=True),
        "vote": lambda: TV.init(4),
        "segments": lambda: tiegm.segment_batch(0, [0], [0]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_stream_package_exports_the_reference_names():
    import repro.stream as jstream
    import repro_torch.stream as tstream

    assert sorted(tstream.__all__) == sorted(jstream.__all__)
    for name in tstream.__all__:
        assert hasattr(tstream, name), name


def test_port_stream_imports_no_jax():
    """The fleet, the obs core, the example and the benchmark import
    neither jax nor anything of the JAX package (a fresh interpreter:
    this one has jax)."""
    code = (
        "import sys, repro_torch.stream, repro_torch.obs, "
        "repro_torch.concurrency, repro_torch.examples.stream_fleet, "
        "repro_torch.benchmarks.stream_throughput, repro_torch.obs.trace\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

"""PyTorch port vs JAX package on the open-loop load lab
(`obs.loadlab`) and its HTML report (`obs.report`).

The knee, SLO-burn, tail and coordinated-omission helpers are numpy in
both packages and must return identical records, and raise the same
errors. The port cannot reproduce jax's threefry, so its arrival
schedules are held to properties (deterministic in their seed path,
valid for the fleet loop, per-patient rates within 10% — over 3 sigma of
a Poisson count of 1 000); the stream sweeps of both packages are fed
one list of segment refs built with numpy and must give the same record
(virtual time: every float equal). Given the same record, the two
reports' HTML must be byte-identical.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import CPU, n, np_params

from repro import obs as jobs
from repro.core import compiler as jc
from repro.core import perf_model as jperf
from repro.core import spe as jspe
from repro.core import vadetect as jva
from repro.obs import loadlab as jloadlab
from repro.obs import report as jreport
from repro.stream import runner as jrunner
from repro.stream import sources as jsources
from repro_torch import convert, obs
from repro_torch.core import compiler as tc
from repro_torch.core import vadetect as tva
from repro_torch.obs import loadlab
from repro_torch.obs import report
from repro_torch.stream import runner as trunner
from repro_torch.stream import sources as tsources

REPO = Path(__file__).resolve().parents[1]
SWEEP = dict(n_patients=8, buckets=(8, 16),
             load_fractions=(0.25, 0.5, 1.0, 2.0, 3.0),
             segments_at_capacity=192)  # tests/test_loadlab.py's size


@pytest.fixture(autouse=True)
def _reset_obs():
    yield
    obs.reset()
    jobs.reset()


def _outcome(fn, *args, **kwargs):
    """fn's return value, or its error's type and message."""
    try:
        return "ok", fn(*args, **kwargs)
    except (AssertionError, ValueError) as e:
        return type(e).__name__, str(e)


# ---------------------------------------------------------------------------
# the numpy helpers: the reference's outputs exactly
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(0)
_TAILS = {
    "empty": [],
    "one": [0.25],
    "exp_1000": list(_RNG.exponential(0.01, 1000)),
    "ties": [0.1] * 7 + [0.3, 0.3],
}


@pytest.mark.parametrize("name", sorted(_TAILS))
def test_tail_summary_equals_the_reference(name):
    assert loadlab.tail_summary(_TAILS[name]) == \
        jloadlab.tail_summary(_TAILS[name])


def _pts(p99s, rates=None):
    rates = rates or [float(i + 1) for i in range(len(p99s))]
    return [{"offered_load": r, "p99_s": v, "p50_s": v}
            for r, v in zip(rates, p99s)]


_KNEES = {
    "one_point": (_pts([0.1]), {}),
    "no_baseline": (_pts([None, None]), {}),
    "zero_baseline": (_pts([0.0, 0.1]), {}),
    "detected": (_pts([0.01, 0.012, 0.011, 0.05, 0.4]), {}),
    "flat": (_pts([0.01, 0.012, 0.011, 0.013]), {}),
    "low_rate_outlier": (_pts([0.5, 0.01, 0.011, 0.012]), {}),
    "unsorted_with_none": (
        _pts([0.2, None, 0.01, 0.011], [4.0, 3.0, 1.0, 2.0]), {}),
    "p50_growth_2": (_pts([0.01, 0.015, 0.03, 0.05]),
                     {"metric": "p50_s", "growth_factor": 2.0}),
}


@pytest.mark.parametrize("name", sorted(_KNEES))
def test_locate_knee_equals_the_reference(name):
    points, kw = _KNEES[name]
    assert loadlab.locate_knee(points, **kw) == \
        jloadlab.locate_knee(points, **kw)


_SLOS = {
    "no_samples": ((0.1, 0.99), (0, 0)),
    "met": ((0.1, 0.99), (995, 1000)),
    "burning": ((0.1, 0.99), (950, 1000)),
    "exact_budget": ((0.0, 0.999), (999, 1000)),
    "no_budget": ((0.1, 1.0), (9, 10)),
    "no_budget_all_ok": ((0.1, 1.0), (10, 10)),
}


@pytest.mark.parametrize("name", sorted(_SLOS))
def test_slo_evaluate_equals_the_reference(name):
    (bound, target), (ok, total) = _SLOS[name]
    kw = dict(name="s", metric="m", bound=bound, target=target)
    assert loadlab.SLO(**kw).evaluate(ok, total) == \
        jloadlab.SLO(**kw).evaluate(ok, total)


_GUARDS = {
    "sub_saturated": ([0.2, 0.3], [0.1, 0.3], False),
    "overload_excess": ([0.5, 0.9, 1.2], [0.1, 0.2, 0.2], True),
    "within_quantization": ([0.1 - 5e-10], [0.1], False),
    "violated": ([0.1, 0.05], [0.1, 0.2], False),  # AssertionError
    "no_excess_at_overload": ([0.1, 0.2], [0.1, 0.2], True),  # AssertionError
    "unpaired": ([0.1, 0.2], [0.1], False),  # ValueError
    "empty": ([], [], False),  # ValueError
}


@pytest.mark.parametrize("name", sorted(_GUARDS))
def test_co_guard_equals_the_reference(name):
    a, b, saturated = _GUARDS[name]
    got = _outcome(loadlab.co_guard, a, b, saturated=saturated)
    want = _outcome(jloadlab.co_guard, a, b, saturated=saturated)
    assert got == want
    expected = {"violated": "AssertionError",
                "no_excess_at_overload": "AssertionError",
                "unpaired": "ValueError", "empty": "ValueError"}
    assert got[0] == expected.get(name, "ok")


# ---------------------------------------------------------------------------
# arrival schedules: keyed by seed paths
# ---------------------------------------------------------------------------


def test_seed_paths_extend_the_entropy_list():
    """fold_in(fold_in(PRNGKey(s), j), u) is SeedSequence([s, j, u]); an
    int seed is the path (seed,)."""
    rng = np.random.default_rng(np.random.SeedSequence([5, 2, 0]))
    want = np.cumsum(rng.standard_exponential(16, dtype=np.float32)
                     .astype(np.float64) / 4.0)
    got = loadlab.arrival_times((5, 2), 0, rate_hz=4.0, n=16)
    assert np.array_equal(got, want)
    assert np.array_equal(loadlab.arrival_times(5, 7, rate_hz=4.0, n=16),
                          loadlab.arrival_times((5,), 7, rate_hz=4.0, n=16))
    assert not np.array_equal(
        got, loadlab.arrival_times((5, 3), 0, rate_hz=4.0, n=16))
    assert loadlab.seed_entropy((1, 2), 3) == [1, 2, 3]
    assert loadlab.seed_entropy(np.int64(4)) == [4]


def test_poisson_segment_refs_are_keyed_valid_and_rate_correct():
    kw = dict(n_patients=8, rate_segments_per_s=80.0, horizon_s=100.0,
              deadline_s=0.5)
    refs = loadlab.poisson_segment_refs(seed=3, **kw)
    assert refs == loadlab.poisson_segment_refs(seed=3, **kw)
    assert refs != loadlab.poisson_segment_refs(seed=4, **kw)
    assert tsources.check_refs(refs, 8) is refs
    assert all(r.deadline_s == r.arrival_s + 0.5 and r.arrival_s <= 100.0
               for r in refs)
    for p in range(8):
        mine = [r for r in refs if r.patient == p]
        assert [r.seq for r in mine] == list(range(len(mine)))
        # patient p's schedule is the [seed, p] stream's, clipped
        t = loadlab.arrival_times(3, p, rate_hz=10.0, n=2008)
        assert [r.arrival_s for r in mine] == list(t[t <= 100.0])
        # 10 segments/s over 100 s: 1 000 expected
        assert abs(len(mine) - 1000) <= 100, (p, len(mine))


# ---------------------------------------------------------------------------
# the stream sweep against the reference's, on one list of refs
# ---------------------------------------------------------------------------


def _numpy_refs(ref_cls, *, n_patients, rate_segments_per_s, horizon_s,
                deadline_s, seed=0, process="poisson", template=None):
    """`poisson_segment_refs`' contract drawn with numpy alone, as either
    package's SegmentRef."""
    refs = []
    for p in range(n_patients):
        rng = np.random.default_rng([seed, 77, p])
        t = np.cumsum(rng.exponential(n_patients / rate_segments_per_s,
                                      int(2 * horizon_s * rate_segments_per_s
                                          / n_patients) + 8))
        refs.extend(ref_cls(patient=p, seq=s, arrival_s=float(ts),
                            deadline_s=float(ts) + deadline_s)
                    for s, ts in enumerate(t[t <= horizon_s]))
    refs.sort(key=lambda r: (r.arrival_s, r.patient, r.seq))
    return refs


@functools.lru_cache(maxsize=None)
def _programs():
    """(jax program, the same program in the port) at full VA width: the
    port compiles numpy weights, the reference gets the port's arrays
    (as tests/test_torch_stream.py builds them; the JAX compiler's equal
    output is held in tests/test_torch_serve.py)."""
    cfg = jva.VAConfig()
    prog_t = tc.compile_model(convert.params_from_numpy(
        np_params(cfg.layers, 0), device=CPU))
    layers = {
        name: jspe.CompiledLayer(
            values_q=jnp.asarray(n(l.values_q)),
            select=jnp.asarray(n(l.select)), scale=jnp.asarray(n(l.scale)),
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


@pytest.fixture(scope="module")
def reference_sweep():
    """The reference's sweep on its default-path runner, over the numpy
    refs."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jloadlab, "poisson_segment_refs",
               functools.partial(_numpy_refs, jsources.SegmentRef))
    try:
        runner = jrunner.FleetRunner(_programs()[0])
        yield jloadlab.sweep_stream(seed=0, runner=runner, **SWEEP)
    finally:
        mp.undo()
        jobs.reset()


def test_sweep_stream_equals_the_reference(reference_sweep, monkeypatch):
    monkeypatch.setattr(loadlab, "poisson_segment_refs",
                        functools.partial(_numpy_refs, tsources.SegmentRef))
    runner = trunner.FleetRunner(_programs()[1], path="twin", device="cpu")
    got = loadlab.sweep_stream(seed=0, runner=runner, **SWEEP)
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(reference_sweep, sort_keys=True)
    # the run is the reference test's: every verdict holds
    assert got["knee"]["detected"]
    assert got["coordinated_omission_guard"]["strictly_greater_at_overload"]
    assert got["overload"] == {"verdict": "graceful_degradation",
                               "urgent_survived": True,
                               "never_dropped": True}


def test_sweep_stream_builds_its_runner_on_the_device():
    """With no runner, the twin runner over `vadetect.init` from `seed`
    is built on `device` (the draws reach the fleet through the port's
    own `poisson_segment_refs`)."""
    small = dict(SWEEP, load_fractions=(0.5, 2.0), segments_at_capacity=64)
    got = loadlab.sweep_stream(seed=0, device="cpu", **small)
    runner = trunner.FleetRunner(
        tc.compile_model(tva.init(torch.Generator().manual_seed(0),
                                  device="cpu")), device="cpu")
    assert got == loadlab.sweep_stream(seed=0, runner=runner, **small)
    assert [p["n_segments"] for p in got["points"]] == \
        [p["count"] for p in got["points"]]


# ---------------------------------------------------------------------------
# the HTML report: byte-identical to the reference's
# ---------------------------------------------------------------------------


def _record(stream: dict) -> dict:
    """The reference's stream sweep beside hand-built serve, frontend and
    lineage sections (a knee, an SLO bound on the latency axis, markup in
    a request id, a phase without a colour of its own, an empty
    sample)."""
    serve_pts = []
    for frac, p99 in ((0.25, 0.012), (0.5, 0.013), (1.0, 0.02),
                      (2.0, 0.09), (4.0, 0.41)):
        serve_pts.append({
            "offered_load": 40.0 * frac, "load_fraction": frac,
            "n_requests": 32, "achieved_rps": 38.0 * min(frac, 1.1),
            "p50_s": p99 / 2, "p99_s": p99,
            "p999_s": p99 * 1.1,
            "latency": {"max_s": p99 * 1.2},
            "ttft": {"p50_s": p99 / 4},
        })
    serve = {
        "engine": "serve", "timebase": "wall", "capacity_rps": 40.0,
        "points": serve_pts,
        "knee": jloadlab.locate_knee(serve_pts),
        "slo": {"declared": {"name": "serve.ttft.p99",
                             "metric": "ttft_from_intended_s",
                             "bound": 0.05, "target": 0.99},
                "points": [{"offered_load": p["offered_load"],
                            "load_fraction": p["load_fraction"],
                            **jloadlab.SLO("serve.ttft.p99", "m", 0.05,
                                           0.99).evaluate(32 - i, 32)}
                           for i, p in enumerate(serve_pts)],
                "met_sub_saturated": True},
        "coordinated_omission_guard": {"intended_ge_dequeue": True,
                                       "mean_queue_excess_s": 0.0031,
                                       "samples": 32},
        "overload": {"verdict": "graceful_degradation",
                     "throughput_retention": 0.92},
    }
    frontend = {"engine": "frontend", "timebase": "wall",
                "points": [dict(p) for p in serve_pts[:3]],
                "overload": {"verdict": "queue_collapse"}}

    def sample(rid, wait, phases):
        return {"request_id": rid, "queue_wait_s": wait,
                "phases_s": phases,
                "total_s": wait + sum(phases.values())}

    lineage = {
        "serve": {"requests": 3, "min_distinct_hops": 5,
                  "max_distinct_hops": 6, "samples": [
                      sample("serve:0", 0.004, {"prefill": 0.002,
                                                "seat": 0.0005,
                                                "decode": 0.03}),
                      sample("serve:<1&2>", 0.0, {"prefill": 0.0021,
                                                  "decode": 0.028}),
                      sample("serve:3", 1.5e-4, {"prefill": 0.002,
                                                 "other": 0.001})]},
        "stream": {"requests": 2, "min_distinct_hops": 5,
                   "max_distinct_hops": 5, "samples": [
                       sample("stream:0:0", 2e-4, {"classify": 7e-4,
                                                   "vote": 1e-4}),
                       {"request_id": "stream:1:0", "total_s": 0.0}]},
    }
    return {"benchmark": "load_sweep", "smoke": True,
            "created_unix": 1760000000,
            "telemetry": {"schema_version": 1},
            "serve": serve, "stream": stream, "frontend": frontend,
            "lineage": lineage}


def test_render_report_is_byte_identical(reference_sweep, tmp_path):
    rec = _record(reference_sweep)
    mine = report.render_report(rec, str(tmp_path / "port.html"))
    theirs = jreport.render_report(rec, str(tmp_path / "ref.html"))
    got, want = Path(mine).read_bytes(), Path(theirs).read_bytes()
    assert got == want
    # every chart parses as XML, and all three kinds are there
    svgs = got.decode().split("<svg")[1:]
    assert len(svgs) == 4  # two tail curves, two waterfalls
    for frag in svgs:
        ET.fromstring("<svg" + frag.split("</svg>")[0] + "</svg>")
    # a record of one sweep (a launcher's --json) renders the same too
    one = {"stream": reference_sweep}
    assert Path(report.render_report(one, str(tmp_path / "a.html"))
                ).read_bytes() == Path(jreport.render_report(
                    one, str(tmp_path / "b.html"))).read_bytes()


def test_loadlab_cli_renders_a_record(reference_sweep, tmp_path):
    path = tmp_path / "record.json"
    path.write_text(json.dumps(_record(reference_sweep)))
    out = tmp_path / "report.html"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.loadlab", str(path),
         "-o", str(out)],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
    )
    assert proc.returncode == 0, proc.stderr
    assert f"wrote {out}" in proc.stdout
    want = jreport.render_report(_record(reference_sweep),
                                 str(tmp_path / "ref.html"))
    assert out.read_bytes() == Path(want).read_bytes()

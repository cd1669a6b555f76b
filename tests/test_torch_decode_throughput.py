"""The `decode_throughput` benchmark's twin (`repro_torch.benchmarks.
decode_throughput`) against the reference's, on the CPU.

The twin's smoke runs over 8 spawned gloo ranks (the reference forces 8
host devices); the reference's pieces run in a subprocess with 8 forced
host devices, beside it: each (arch, mesh) cell's plan
(`serve.sharded.plan_decode`), `measure_admission` and `measure_paged`.
Equal: the record's keys (each cell's, plus the device it ran on), each
mesh's per-device param and cache bytes, replicated baseline and
replication factor, the admission work at every pool, and the paged
section (`n_pages`, the byte totals, the peak concurrency, the bytes in
use). The twin's record passes every assertion of the reference's `main`
(`check`), its cell audit included; wall times are not compared.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.benchmarks import decode_throughput as D

REPO = Path(__file__).resolve().parents[1]
REF_S = 240  # the reference's pieces, JAX's compiles included

# the reference's pieces of its smoke record, as JSON on stdout
REFERENCE = r"""
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location(
    "ref_decode", sys.argv[1] + "/benchmarks/decode_throughput.py")
D = importlib.util.module_from_spec(spec)
spec.loader.exec_module(D)
import jax
from repro import configs, obs
from repro.launch.mesh import make_serving_mesh
from repro.models import api
from repro.serve import sharded as SH

obs.configure(enabled=True)
cells = []
for arch in D.ARCHS:
    model = api.build_model(configs.reduced(arch), tp=1, max_seq=8 + 24 + 2)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    for spec in ("1", "8", "4x2"):
        plan = SH.plan_decode(model, params, make_serving_mesh(spec),
                              batch_size=32)
        cells.append({
            "arch": model.cfg.name, "mesh": spec,
            "devices": plan.n_devices, "n_data": plan.n_data,
            "param_bytes_per_device": plan.param_bytes_per_device,
            "cache_bytes_per_device": plan.cache_bytes_per_device,
            "cache_bytes_replicated_baseline": plan.cache_bytes_total,
            "cache_replication_factor": plan.cache_replication_factor,
            "modeled_tokens_per_s": D.modeled_tokens_per_s(plan)})
print(json.dumps({
    "cells": cells,
    "admission": D.measure_admission(D.ARCHS[0], prompt_len=8),
    "paged": D.measure_paged(D.ARCHS[0]),
}))
"""

# the keys of the reference's record and sections (benchmarks/
# decode_throughput.py: run_cell, _admission_cell, measure_paged, main)
RECORD_KEYS = {"benchmark", "n_host_devices", "hbm_bw_bytes_per_s",
               "reduced_configs", "cells", "scaling", "admission", "paged",
               "telemetry", "cell_audit"}
CELL_KEYS = {"arch", "mesh", "devices", "n_data", "batch", "prompt_len",
             "max_new", "wall_s", "wall_tokens_per_s", "modeled_tokens_per_s",
             "param_bytes_per_device", "cache_bytes_per_device",
             "cache_bytes_replicated_baseline", "cache_replication_factor"}
PLAN_KEYS = ("devices", "n_data", "param_bytes_per_device",
             "cache_bytes_per_device", "cache_bytes_replicated_baseline",
             "cache_replication_factor", "modeled_tokens_per_s")
PAGED_KEYS = ("n_pages", "span", "dense_cache_bytes_total",
              "paged_cache_bytes_total", "dense_peak_concurrent",
              "paged_peak_concurrent", "concurrency_gain", "bytes_in_use",
              "recompiles_after_warmup", "admission_rowsteps",
              "admission_prefills")


@pytest.fixture(scope="module")
def trace_prefix(tmp_path_factory):
    return str(tmp_path_factory.mktemp("decode_trace") / "decode")


@pytest.fixture(scope="module")
def records(trace_prefix):
    """(the twin's smoke record, the reference's pieces), run at once;
    the twin writes its trace to `trace_prefix` (`--trace-out`)."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(REPO / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(REPO)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        rec = D.run(smoke=True, device="cpu", trace_out=trace_prefix)
        out, err = ref.communicate(timeout=REF_S)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return rec, json.loads(out.strip().splitlines()[-1])


def test_the_smoke_record_passes_the_references_assertions(records):
    rec, _ = records
    D.check(rec)
    assert rec["n_host_devices"] == D.CPU_RANKS
    assert {c["device"] for c in rec["cells"]} == {"cpu (gloo)"}
    ca = rec["cell_audit"]
    assert sorted(ca["cells"]) == ["serve.chunk", "serve.decode_step",
                                   "serve.prefill", "serve.prefill.w8",
                                   "serve.seat", "serve.seat.w8"]
    assert ca["cells"]["serve.seat.w8"]["donation_aliased"] is True
    # the sharded engine's per-width cells hand their collectives over
    assert ca["cells"]["serve.prefill.w8"]["collectives"]


def test_the_record_keys_are_the_references(records):
    rec, _ = records
    assert set(rec) == RECORD_KEYS
    for c in rec["cells"]:
        assert set(c) == CELL_KEYS | {"device"}


def test_plans_admission_and_paged_equal_the_references(records):
    rec, ref = records
    got = {(c["arch"], c["mesh"]): c for c in rec["cells"]}
    assert set(got) == {(c["arch"], c["mesh"]) for c in ref["cells"]}
    for want in ref["cells"]:
        cell = got[(want["arch"], want["mesh"])]
        for k in PLAN_KEYS:
            assert cell[k] == pytest.approx(want[k], rel=1e-12), (want, k)
    key = lambda c: (c["mesh"], c["pool"])  # noqa: E731
    assert ({key(c): c["admission_rowsteps"] for c in rec["admission"]}
            == {key(c): c["admission_rowsteps"] for c in ref["admission"]})
    assert ({key(c): c["admission_prefills"] for c in rec["admission"]}
            == {key(c): c["admission_prefills"] for c in ref["admission"]})
    for k in PAGED_KEYS:
        assert rec["paged"][k] == ref["paged"][k], k


def test_the_record_passes_both_schema_guards(records, tmp_path):
    """The port's bench-schema guard and the reference's script (loaded
    by path; it imports nothing of jax for a benchmark record) pass the
    twin's record: its telemetry, paged and cell_audit sections."""
    import importlib.util

    from repro_torch import obs
    from repro_torch.benchmarks import check_schema

    rec, _ = records
    path = tmp_path / "BENCH_decode.json"
    path.write_text(json.dumps(rec))
    spec = importlib.util.spec_from_file_location(
        "_reference_check_bench_schema",
        REPO / "scripts" / "check_bench_schema.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert check_schema.check_record("rec", rec, obs.SCHEMA_VERSION) == []
    assert ref.check_file(str(path), obs.SCHEMA_VERSION) == []


def test_check_fails_on_a_violation(records):
    rec, _ = records
    bad = {**rec, "cell_audit": {**rec["cell_audit"],
                                 "violations_total": 1}}
    with pytest.raises(AssertionError):
        D.check(bad)


def test_trace_out_writes_both_files_that_join(records, trace_prefix):
    """`--trace-out PREFIX`: rank 0 writes the JSONL event log and the
    Chrome export, which validate as the stream twin's do, and every
    request's lineage joins from the log."""
    from repro_torch import obs

    n = obs.validate_jsonl(trace_prefix + ".jsonl")
    assert n > 0 and obs.validate_chrome(trace_prefix + ".json") >= n
    with open(trace_prefix + ".jsonl") as f:
        events = [json.loads(line) for line in f if line.strip()]
    joined = obs.assert_joined(events, min_hops=2)
    assert joined

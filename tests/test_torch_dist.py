"""PyTorch port vs JAX package: `dist.sharding`'s rules,
`dist.compression` and `launch.mesh`'s spec parsing.

In process (no spawning):
- every rule against the reference's, leaf for leaf, over each
  `configs/` family's (reduced) parameter tree and decode cache, on
  ("data", "model") and ("pod", "data", "model") meshes with axis sizes
  1, 2, 4 and 16 (the reference takes a shape-only mesh, the port its
  `MeshShape`): equal specs (a spec is the tuple a `PartitionSpec`
  holds), the same strict raises, the same `bytes_per_device`;
- `quantize_leaf` and `compress_residual` on numpy inputs: the same codes
  (round half to even) with scales within a float32 ulp (the reference's
  compiled /127 and the port's division can round apart), residuals to
  float32 rounding of that scale; telescoping over steps and the finite
  guard (tests/test_dist.py's 1e-4);
- every reduction at n = 1 (a world-1 gloo group here, a 1-device
  `shard_map` there);
- `parse_mesh_spec` / `parse_multipod_spec`.

Across ranks (one module fixture): a spawned gloo group of 4 ranks runs
the reductions at n = 2 and 4 (`tests/_torch_dist_ranks.py`) while a
subprocess runs the reference with 4 forced host devices on the same
numpy inputs (`tests/_dist_reference.py`), a non-finite injection
included; then `benchmarks.dist_compression` on 4 ranks. Means and
residuals within float32 rounding of the leaf's amax (1e-6 of it: the
scales may differ in their last bit; a code flip would move a value by
1/127 of it); two-stage's stage-2 codes, re-quantized from a sum whose
order differs at n = 4, within one code step there.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import _torch_dist_ranks as ranks
from repro import configs as jconfigs
from repro.dist import compression as JC
from repro.dist import sharding as jshd
from repro.launch import mesh as jmesh
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.benchmarks import dist_compression as tbench
from repro_torch.dist import compression as TC
from repro_torch.dist import sharding as tshd
from repro_torch.launch import _spawn
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api as tapi

REPO = Path(__file__).resolve().parents[1]
SIZES = (1, 2, 4, 16)
TIMEOUT_S = 59  # each spawn and subprocess


class _JaxMeshShape:
    """What the reference's rules read of a mesh: names and sizes."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _meshes(size: int):
    for names, sizes in ((("data", "model"), (size, size)),
                         (("pod", "data", "model"), (2, size, size))):
        yield _JaxMeshShape(names, sizes), tshd.MeshShape(names, sizes)


def _jpaths(tree, is_leaf=None) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {jshd._path_str(kp): leaf for kp, leaf in flat}


def _tpaths(tree) -> dict:
    out = {}
    tshd.map_with_path(lambda p, x: out.__setitem__("/".join(p), x), tree)
    return out


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _norm(spec) -> tuple:
    """A spec's entries with a one-name tuple written as the name, as
    `PartitionSpec` stores it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _same_specs(jspecs, tspecs) -> None:
    got, want = _tpaths(tspecs), _jpaths(jspecs, _is_spec)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _norm(got[k]) == _norm(tuple(want[k])), (k, got[k], want[k])


@pytest.fixture(scope="module")
def trees():
    """{family: (jax cfg, port cfg, jax param shapes, port params, jax
    cache, port cache)} of every family's reduced config."""
    out = {}
    for name in tconfigs.ALL_ARCHS:
        jcfg, tcfg = jconfigs.reduced(name), tconfigs.reduced(name)
        mj = japi.build_model(jcfg, tp=1, max_seq=32)
        mt = tapi.build_model(tcfg, tp=1, max_seq=32)
        out[name] = (
            jcfg, tcfg,
            jax.eval_shape(lambda: mj.init(jax.random.PRNGKey(0))),
            mt.init(0, device="cpu"),
            jax.eval_shape(lambda: mj.init_cache(4)),
            mt.init_cache(4, device="cpu"),
        )
    return out


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", tconfigs.ALL_ARCHS)
def test_param_and_cache_specs_equal_reference(trees, name, size):
    jcfg, tcfg, jp, tp, jc, tc = trees[name]
    for jm, tm in _meshes(size):
        jspecs = jshd.param_specs(jp, jcfg, jm)
        tspecs = tshd.param_specs(tp, tcfg, tm)
        _same_specs(jspecs, tspecs)
        assert tshd.bytes_per_device(tp, tspecs, tm) == \
            jshd.bytes_per_device(jp, jspecs, jm)
        _same_specs(jshd.cache_specs(jc, jcfg, jm),
                    tshd.cache_specs(tc, tcfg, tm))
        try:
            jshd.cache_specs(jc, jcfg, jm, strict=True)
            raised = False
        except jshd.ShardingGuardError:
            raised = True
        if raised:
            with pytest.raises(tshd.ShardingGuardError):
                tshd.cache_specs(tc, tcfg, tm, strict=True)
        else:
            _same_specs(jshd.cache_specs(jc, jcfg, jm, strict=True),
                        tshd.cache_specs(tc, tcfg, tm, strict=True))
        assert tshd.data_axes(tcfg, tm) == jshd.data_axes(jcfg, jm)


@pytest.mark.parametrize("size", SIZES)
def test_batch_specs_and_the_strict_guard(size):
    cfg_j, cfg_t = jconfigs.reduced("qwen3_8b"), tconfigs.reduced("qwen3_8b")
    shapes = {"tokens": (8, 16), "targets": (8, 16), "frames": (6, 4, 3)}
    jt = {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in shapes.items()}
    tt = {k: torch.zeros(v, dtype=torch.int32) for k, v in shapes.items()}
    for jm, tm in _meshes(size):
        _same_specs(jshd.batch_specs(jt, cfg_j, jm),
                    tshd.batch_specs(tt, cfg_t, tm))
        n = tshd._axis_size(tshd.data_axes(cfg_t, tm), tm)
        if n > 1 and any(s[0] % n for s in shapes.values()):
            with pytest.raises(tshd.ShardingGuardError):
                tshd.batch_specs(tt, cfg_t, tm, strict=True)
            with pytest.raises(jshd.ShardingGuardError):
                jshd.batch_specs(jt, cfg_j, jm, strict=True)
        scalar = {"s": torch.zeros(())}
        if n > 1:
            with pytest.raises(tshd.ShardingGuardError, match="scalar"):
                tshd.batch_specs(scalar, cfg_t, tm, strict=True)
        else:
            assert tshd.batch_specs(scalar, cfg_t, tm, strict=True) == \
                {"s": ()}


def test_spec_shard_factor_and_the_local_block():
    tm = tshd.MeshShape(("pod", "data", "model"), (2, 4, 3))
    jm = _JaxMeshShape(("pod", "data", "model"), (2, 4, 3))
    for spec in ((), (None, "data"), (("pod", "data"), "model"),
                 ("model", None, "pod")):
        assert tshd.spec_shard_factor(spec, tm) == \
            jshd.spec_shard_factor(P(*spec), jm)
    assert tshd.global_shape((1, 5), ("pod",), tm) == (2, 5)
    with pytest.raises(ValueError, match="leaves"):
        tshd.bytes_per_device({"a": torch.zeros(2)}, {}, tm)

    class _Coords(tshd.MeshShape):  # a mesh whose rank sits at (1, 2, 0)
        def get_local_rank(self, axis):
            return {"pod": 1, "data": 2, "model": 0}[axis]

    cm = _Coords(("pod", "data", "model"), (2, 4, 3))
    x = torch.arange(2 * 8 * 6).reshape(16, 6)
    # ("pod", "data") on dim 0: 8 blocks of 2 rows, block 1·4 + 2 = 6
    got = tshd.shard_local(x, (("pod", "data"), "model"), cm)
    assert torch.equal(got, x[12:14, 0:2])
    with pytest.raises(tshd.ShardingGuardError):
        tshd.shard_local(torch.zeros(5), ("data",), cm)


def test_parse_specs_equal_reference():
    for spec in ("8", "4x2", "1X1"):
        assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)
    for spec in ("2x4", "2x2x2", "1x1"):
        assert tmesh.parse_multipod_spec(spec) == \
            jmesh.parse_multipod_spec(spec)
    for bad in ("2x2x2x2", ""):
        with pytest.raises(ValueError):
            tmesh.parse_mesh_spec(bad)
    for bad in ("4", "2x2x2x2"):
        with pytest.raises(ValueError):
            tmesh.parse_multipod_spec(bad)
        with pytest.raises(ValueError):
            jmesh.parse_multipod_spec(bad)


# ---------------------------------------------------------------------------
# compression in process
# ---------------------------------------------------------------------------


def _ulp(x: float) -> float:
    return float(np.spacing(np.float32(x)))


@pytest.mark.parametrize("case", ["ties", "normal", "zeros", "tiny"])
def test_quantize_leaf_equals_reference(case):
    rng = np.random.default_rng(7)
    g = {
        # amax 127: scale 1, exact .5 ties round half to even
        "ties": np.array([127, 63.5, 0.5, 1.5, 2.5, -2.5, -0.5, -127],
                         np.float32),
        "normal": (rng.standard_normal((33, 17)) * 3).astype(np.float32),
        "zeros": np.zeros((4, 5), np.float32),
        "tiny": (rng.standard_normal(50) * 1e-20).astype(np.float32),
    }[case]
    qj, sj = JC.quantize_leaf(jnp.asarray(g))
    qt, st = TC.quantize_leaf(torch.from_numpy(g))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert abs(float(st) - float(sj)) <= _ulp(float(sj))
    deq = TC.dequantize_leaf(qt, st).numpy()
    assert np.abs(deq - g).max() <= float(st) / 2 * (1 + 1e-6)
    if case == "ties":
        assert qt.tolist() == [127, 64, 0, 2, 2, -2, 0, -127]


def test_compress_residual_telescopes_and_guards():
    rng = np.random.default_rng(3)
    err_j = jnp.zeros(64)
    err_t = torch.zeros(64)
    sent, total = np.zeros(64), np.zeros(64)
    for step in range(5):
        g = rng.standard_normal(64).astype(np.float32)
        if step == 2:
            g[:3] = [np.inf, -np.inf, np.nan]
        qj, sj, err_j = JC.compress_residual(jnp.asarray(g), err_j)
        qt, st, err_t = TC.compress_residual(torch.from_numpy(g), err_t)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert torch.isfinite(err_t).all()
        np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j),
                                   rtol=0, atol=127 * _ulp(float(st)))
        sent += TC.dequantize_leaf(qt, st).numpy()
        total += np.where(np.isfinite(g), g, 0.0)
    # telescoping: sum(dequantized sent) + residual == sum(grads), where
    # no step was non-finite (the guard zeroes g + err there, the carried
    # residual with it)
    np.testing.assert_allclose((sent + err_t.numpy())[3:], total[3:],
                               rtol=1e-4, atol=1e-4)


def _jax_one_pod(fn, *args):
    mesh = jax.make_mesh((1,), ("pod",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    return shard_map(fn, mesh=mesh, in_specs=(P(),) * len(args),
                     out_specs=P(), check_rep=False)(*args)


def test_reductions_at_one_pod_equal_reference():
    """A world-1 gloo group against the reference's 1-device shard_map:
    at n = 1 the mean is the dequantized leaf, codes equal."""
    rng = np.random.default_rng(5)
    g = {"a": (rng.standard_normal((6, 5)) * 2).astype(np.float32),
         "b": rng.standard_normal(11).astype(np.float32)}
    g["b"][0] = np.nan
    gj = {k: jnp.asarray(v) for k, v in g.items()}
    gt = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    zj = {k: jnp.zeros_like(v) for k, v in gj.items()}
    e2j = {k: jnp.zeros(JC.two_stage_shard_len(v.size, 1))
           for k, v in gj.items()}
    mj, ej = _jax_one_pod(lambda a, b: JC.compressed_psum_mean(a, b, "pod"),
                          gj, zj)
    tj, t1j, t2j = _jax_one_pod(
        lambda a, b, c: JC.two_stage_psum_mean(a, b, c, "pod"), gj, zj, e2j)
    uj = _jax_one_pod(lambda a: JC.uncompressed_psum_mean(a, "pod"), gj)
    with _spawn.process_group("cpu", timeout_s=TIMEOUT_S):
        group = torch.distributed.group.WORLD
        zt = {k: torch.zeros_like(v) for k, v in gt.items()}
        mt, et = TC.compressed_psum_mean(gt, zt, group)
        tt, t1t, t2t = TC.two_stage_psum_mean(
            gt, zt, {k: torch.zeros(TC.two_stage_shard_len(v.numel(), 1))
                     for k, v in gt.items()}, group)
        ut = TC.uncompressed_psum_mean(gt, group)
        raw = TC.uncompressed_psum_mean(gt, group, finite_guard=False)
    assert not torch.distributed.is_initialized()
    for k in g:
        amax = float(np.nanmax(np.abs(g[k])))
        for got, want in ((mt, mj), (et, ej), (tt, tj), (t1t, t1j),
                          (ut, uj)):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-6 * amax)
        assert t2t[k].abs().max() <= amax / 127  # stage 2 of the mean
    assert torch.isnan(raw["b"][0]) and torch.isfinite(ut["b"]).all()


# ---------------------------------------------------------------------------
# across ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """(port record, reference arrays, inputs) of the reductions at 2 and
    4 ranks; per-pod leaves l0 (5, 7) and l1 (37,), pod 0 injecting
    inf, -inf and nan into l1."""
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    data = {"l0": (rng.standard_normal((4, 5, 7)) * 3).astype(np.float32),
            "l1": rng.standard_normal((4, 37)).astype(np.float32)}
    data["l1"][0, :3] = [np.inf, -np.inf, np.nan]
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    with open(tmp / "ref.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_dist_reference.py"),
             "compression", str(tmp / "in.npz"), str(tmp / "out.npz")],
            env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            port = _spawn.run(ranks.compression, 4, device="cpu",
                              args=(data,), timeout_s=TIMEOUT_S)
            proc.wait(timeout=TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
    assert proc.returncode == 0, (tmp / "ref.log").read_text()
    return port, dict(np.load(tmp / "out.npz")), data


def _amax(data, n, leaf) -> float:
    x = data[leaf][:n]
    return float(np.abs(np.where(np.isfinite(x), x, 0)).max())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("scheme", ["gather", "two_stage", "uncompressed",
                                    "uncompressed_raw"])
def test_reductions_across_ranks_equal_reference(ranked, scheme, n):
    port, ref, data = ranked
    keys = [k for k in ref if k.startswith(f"n{n}/{scheme}/")]
    assert keys
    for k in keys:
        leaf = k.rsplit("/", 1)[1]
        amax = _amax(data, n, leaf)
        got, want = port[k], ref[k]
        assert got.shape == want.shape, k
        if scheme == "uncompressed_raw":
            np.testing.assert_array_equal(np.isfinite(got),
                                          np.isfinite(want))
            fin = np.isfinite(want)
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                       atol=1e-6)
            continue
        assert np.isfinite(got).all(), k
        tol = 1e-6 * amax
        if scheme == "two_stage" and n == 4 and "err1" not in k:
            tol = amax / 127  # a stage-2 code may flip (see docstring)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_bytes_handed_to_the_collectives(ranked, n):
    """One call: the int8 codes and the float32 scales, against 4 bytes
    an element for the f32 all-reduce."""
    port, _, data = ranked
    sizes = [data[k][0].size for k in ("l0", "l1")]
    shards = [TC.two_stage_shard_len(s, n) for s in sizes]
    assert port[f"n{n}/gather/wire"] == {"all_gather": sum(sizes) + 4 * 2}
    assert port[f"n{n}/two_stage/wire"] == {
        "all_to_all": n * sum(shards),
        "all_gather": 4 * 2 + sum(shards) + 4 * 2}
    assert port[f"n{n}/uncompressed/wire"] == {"all_reduce": 4 * sum(sizes)}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """`benchmarks.dist_compression` through `main` on 4 gloo ranks with
    `--trace-out`: (its record, its printed lines, the trace prefix)."""
    tmp = tmp_path_factory.mktemp("dist_trace")
    prefix, log = str(tmp / "dist"), tmp / "stdout.txt"
    # the ranks print to the inherited file descriptor 1: capture it
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        with open(log, "w") as f, pytest.MonkeyPatch.context() as mp:
            os.dup2(f.fileno(), 1)
            mp.setattr(_spawn, "TIMEOUT_S", TIMEOUT_S)
            rec = tbench.main(["--devices", "4", "--smoke", "--trace-out",
                               prefix], device="cpu")
            sys.stdout.flush()
    finally:
        os.dup2(saved, 1)
        os.close(saved)
    return rec, log.read_text(), prefix


def test_dist_compression_benchmark_on_four_ranks(bench):
    """`benchmarks.dist_compression` through `main` on 4 gloo ranks: its
    gates (two-stage ~4x at any n, gather 8/n, fewer bytes handed than
    f32, every loss curve falling) hold."""
    rec, printed, _ = bench
    assert rec["checked"]
    assert sorted({c["n_pods"] for c in rec["sweep"]}) == [2, 4]
    two = [c["modeled_ratio_vs_f32"] for c in rec["sweep"]
           if c["scheme"] == "two_stage"]
    assert all(3.5 < r < 4.3 for r in two)
    assert "all gates passed" in printed


def test_dist_compression_trace_out_writes_both_files(bench):
    """`--trace-out PREFIX`: rank 0 writes the JSONL event log and the
    Chrome export, which validate as the stream twin's do, and every
    dp-step span of the run is in them."""
    import json as _json

    from repro_torch import obs

    _, printed, prefix = bench
    assert "[obs] trace written" in printed
    n = obs.validate_jsonl(prefix + ".jsonl")
    assert n > 0 and obs.validate_chrome(prefix + ".json") >= n
    with open(prefix + ".jsonl") as f:
        events = [_json.loads(line) for line in f if line.strip()]
    assert obs.lineage.join(events) == {}  # no request ids in a train run
    names = {e.get("name") for e in events}
    assert any(str(name).startswith("train/") for name in names), names


def test_dist_compression_record_passes_both_schema_guards(bench, tmp_path):
    """The port's bench-schema guard and the reference's script (loaded
    by path) pass the twin's record: its telemetry and cell_audit."""
    import importlib.util
    import json as _json

    from repro_torch import obs
    from repro_torch.benchmarks import check_schema

    rec = bench[0]
    path = tmp_path / "BENCH_dist.json"
    path.write_text(_json.dumps(rec))
    spec = importlib.util.spec_from_file_location(
        "_reference_check_bench_schema",
        REPO / "scripts" / "check_bench_schema.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert check_schema.check_record("rec", rec, obs.SCHEMA_VERSION) == []
    assert ref.check_file(str(path), obs.SCHEMA_VERSION) == []


@pytest.mark.parametrize("fault", ["two_signatures", "no_peak_memory_on_card"])
def test_dist_compression_check_holds_the_references_gates(bench, fault):
    """`check` fails a record whose `train.dp_step` cell saw two call
    signatures (a retrace after the warm-up: the reference's
    `recompiles == 1`), and one from a card whose peak device memory
    reads 0; the run's own record passes."""
    import copy

    rec = copy.deepcopy(bench[0])
    tbench.check(rec)
    if fault == "two_signatures":
        rec["telemetry"]["recompiles"]["train.dp_step.gather"] = 2
    else:
        rec["device"]["type"] = "cuda"
        rec["telemetry"]["peak_device_memory_bytes"] = 0
    with pytest.raises(AssertionError):
        tbench.check(rec)

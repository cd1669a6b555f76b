"""PyTorch port vs JAX package: sharded LM serving over `data` and `model`
(`serve.sharded`) — placement, the tensor-parallel layers (the packed
`quant_matmul` on each rank's shard; MoE over the experts' hidden axis,
RWKV-6 over its heads), `sharded_generate`, `ShardedEngine` (dense,
paged, chunked; and under seeded interleavings against `sharded_generate`
on the same mesh, the twin of
tests/test_admission_properties.py's sharded property), the plan's
accounting and guards, and `launch.serve --mesh` / the `serve_lm`
example's sharded block.

One module fixture does the multi-rank work: a spawned gloo group of 4
ranks runs the port (`tests/_torch_dist_ranks.py`, `serving`) while
subprocesses (one on 4x1, two on 2x2) run the reference's plan,
placement and compiled prefill and decode steps with 4 forced host
devices
(`tests/_dist_reference.py decode`), on the same numpy params (the
port's draws; the 8-bit cases packed by the port) and seeded prompts. The
reduced qwen3-8b and recurrentgemma-2b on both meshes, olmoe-1b-7b,
llama4-scout (MoE with a shared expert) and rwkv6-3b (float32 and 8-bit)
on 2x2, in float32. The reduced qwen3-8b with every packable linear in
the SPE format (`_spe_tree.sparse_for_serving`, 16:8 at 8 bits) on
2x2: the reference cannot run that tree (its `lax.scan` over the stacked
blocks cannot carry the format's integer `meta`), so it is fed the
port's values, selects and scales as numpy, so no prune tie can differ,
and its sharded run takes the same weights decompressed by the JAX
package's own `kernels._common.decompress_tile`, times the scale. Each spawn and subprocess has its own time
limit.

Tolerances, each for its reason:

- a data-only mesh: each rank runs whole rows with the whole gathered
  weights — tokens equal to the port's single-device `generate` and
  `Engine` and to the reference's sharded run;
- a 2x2 mesh: row-parallel layers sum partial products, so the logits of
  the prefill and of every decode step are held within 1e-4 of
  max|logit| of the reference's sharded run (`F32_REL`,
  tests/test_torch_lm.py), the 8-bit packed path too; qwen3's greedy
  tokens equal the reference's (tests/test_decode_multidevice.py);
- the port against itself (paged against dense pools, the engine
  against the single-device engine or against `sharded_generate` on the
  same mesh, sampled streams): exact.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from _spe_tree import sparse_for_serving
from repro_torch._tree import map_with_path, tree_map
from repro_torch.launch import _spawn
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import engine as TE

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 59  # each spawn and subprocess
F32_REL = 1e-4
SPE_TAGS = [t for t, _, b, _ in ranks.SERVE_CASES if b == ranks.SPE]


def _numpy(tree):
    return tree_map(lambda x: x.numpy() if isinstance(x, torch.Tensor)
                    else x, tree)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(port record, {mesh: reference arrays}, {tag: (model, params)},
    prompts)."""
    tmp = tmp_path_factory.mktemp("sharded")
    built, params_np = {}, {}
    for tag, name, fmt, _ in ranks.SERVE_CASES:
        model = ranks.serve_model(name)
        params = model.init(0, device="cpu")
        if fmt == ranks.SPE:
            params = sparse_for_serving(params, 8)
        elif fmt:
            params = TE.quantize_for_serving(params, fmt)
        built[tag] = (model, params)
        params_np[tag] = _numpy(params)
    prompts = np.random.default_rng(1).integers(
        0, 512, (ranks.SERVE_B, ranks.SERVE_S))
    flat = {"prompts": prompts, "new": ranks.SERVE_NEW,
            "max_seq": ranks.SERVE_MAX_SEQ,
            "cases": np.array([(t, n, str(b))
                               for t, n, b, _ in ranks.SERVE_CASES])}
    for tag, tree in params_np.items():
        map_with_path(lambda path, p, tag=tag: flat.__setitem__(
            f"{tag}/params/" + "/".join(path), p), tree)
    np.savez(tmp / "in.npz", **flat)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    procs = {}
    for i, (spec, tags) in enumerate(ranks.SERVE_REF_PROCS):
        log = open(tmp / f"ref_{i}.log", "w")
        procs[i] = (spec, subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_dist_reference.py"),
             "decode", spec, str(tmp / "in.npz"), str(tmp / f"ref_{i}.npz"),
             tags], env=env, stdout=log, stderr=subprocess.STDOUT), log)
    try:
        port = _spawn.run(ranks.serving, 4, device="cpu",
                          args=({"params": params_np, "prompts": prompts},),
                          timeout_s=TIMEOUT_S)
        ref = {}
        for i, (spec, p, log) in procs.items():
            p.wait(timeout=TIMEOUT_S)
            log.close()
            assert p.returncode == 0, (tmp / f"ref_{i}.log").read_text()
            ref.setdefault(spec, {}).update(np.load(tmp / f"ref_{i}.npz"))
    finally:
        for _, p, log in procs.values():
            if p.poll() is None:
                p.kill()
            log.close()
    return port, ref, built, torch.from_numpy(prompts)


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("tag", ["qwen3", "qwen3_q8", "rg"])
def test_data_mesh_generate_matches_single_device_and_reference(served, tag):
    port, ref, built, prompts = served
    model, params = built[tag]
    want = TE.generate(model, params, prompts, max_new=ranks.SERVE_NEW,
                       device="cpu").numpy()
    np.testing.assert_array_equal(port[f"4x1/{tag}/generate"], want)
    np.testing.assert_array_equal(port[f"4x1/{tag}"]["tokens"], want)
    np.testing.assert_array_equal(ref["4x1"][f"{tag}/generate"], want)
    np.testing.assert_array_equal(ref["4x1"][f"{tag}/tokens"], want)


def test_data_mesh_sampled_generate_matches_single_device(served):
    port, _, built, prompts = served
    model, params = built["qwen3"]
    want = TE.generate(model, params, prompts, max_new=ranks.SERVE_NEW,
                       greedy=False, key=ranks.SAMPLE_KEY, temperature=0.8,
                       top_k=20, device="cpu").numpy()
    np.testing.assert_array_equal(port["4x1/qwen3/sampled"], want)
    greedy = port["4x1/qwen3/generate"]
    assert (want != greedy).any()  # the key was used


@pytest.mark.parametrize("tag", ["qwen3", "qwen3_q8", "rg"])
@pytest.mark.parametrize("spec", ranks.SERVE_MESHES)
def test_logits_every_step_match_reference(served, spec, tag):
    """The prefill's and each decode step's logits within F32_REL of the
    reference's sharded run (recurrentgemma's one KV head is split
    mid-head over `model` at 2x2)."""
    port, ref, _, _ = served
    for t in range(ranks.SERVE_NEW + 1):
        got = port[f"{spec}/{tag}"][f"logits/{t}"]
        want = ref[spec][f"{tag}/logits/{t}"]
        assert got.shape == want.shape
        assert _rel(got, want) <= F32_REL, (t, _rel(got, want))


@pytest.mark.parametrize("tag", ["qwen3", "qwen3_q8"])
def test_tp_mesh_greedy_tokens_match_reference(served, tag):
    port, ref, _, _ = served
    np.testing.assert_array_equal(port[f"2x2/{tag}"]["tokens"],
                                  ref["2x2"][f"{tag}/tokens"])
    np.testing.assert_array_equal(port[f"2x2/{tag}/generate"],
                                  ref["2x2"][f"{tag}/generate"])


def _single_engine(model, params, reqs, batch_size):
    eng = TE.Engine(model, params, batch_size=batch_size, device="cpu")
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=50)
    return [r.output for r in reqs]


def test_sharded_engine_matches_single_device_engine(served):
    """Three requests into two slots on one device, and into a pool of 8
    on the 4x1 and 2x2 meshes: the same outputs (greedy on qwen3)."""
    port, _, _, _ = served
    model = ranks.serve_model("qwen3_8b", max_seq=96)
    params = model.init(0, device="cpu")
    want = _single_engine(model, params,
                          ranks.serve_requests(model.cfg, 3), 2)
    assert port["engine_outputs"] == want
    assert port["engine_done"] and port["engine_drained"]
    assert port["engine_2x2_outputs"] == want


def test_sharded_engine_eos_on_first_token(served):
    eos = served[0]["eos"]
    assert eos["eos_done"] and eos["eos_output"] == [eos["first"]]
    assert eos["tail_done"] and eos["tail_len"] == 3 and eos["drained"]


@pytest.mark.parametrize("pool", ["paged", "paged_chunked", "rg_paged",
                                  "rg_paged_chunked"])
def test_sharded_paged_matches_sharded_dense(served, pool):
    """tests/test_paged_properties.py's 12 requests on the 4x1 mesh, for
    qwen3 and (`rg_`) recurrentgemma, its sharded cases: the paged pool
    (pages over the same data axis as their slots), with and without
    chunked prefill, equals the dense sharded pool; every mapped page
    stays on its slot's shard; nothing leaks."""
    port, _, _, _ = served
    rg = pool.startswith("rg_")
    prefix = "rg_" if rg else ""
    dense, paged = port[f"pool_{prefix}dense"], port[f"pool_{pool}"]
    assert dense["done"] and paged["done"]
    assert paged["outputs"] == dense["outputs"]
    assert paged["on_shard"] and paged["allocated_after"] == 0
    model = ranks.serve_model(
        "recurrentgemma_2b" if rg else "qwen3_8b", max_seq=96)
    want = _single_engine(model, model.init(0, device="cpu"),
                          ranks.paged_requests(model.cfg), 8)
    assert dense["outputs"] == want


@pytest.mark.parametrize("spec", ranks.SERVE_MESHES)
@pytest.mark.parametrize("tag", ["qwen3", "qwen3_q8", "rg"])
def test_placed_bytes_equal_plan(served, spec, tag):
    """Rank 0's placed params and cache hold exactly the plan's
    per-device bytes."""
    placed_p, plan_p, placed_c, plan_c = served[0][f"{spec}/{tag}"]["bytes"]
    assert placed_p == plan_p and placed_c == plan_c


def test_engine_placed_bytes_equal_plan(served):
    port = served[0]
    for key in ("engine_cache_bytes", "engine_2x2_cache_bytes"):
        placed, plan = port[key]
        assert placed == plan, key
    for pool in ("dense", "paged", "paged_chunked", "rg_dense", "rg_paged",
                 "rg_paged_chunked"):
        placed, plan = port[f"pool_{pool}"]["cache_bytes"]
        assert placed == plan, pool


@pytest.mark.parametrize("tag", ["qwen3", "qwen3_q8", "rg"])
def test_decode_step_within_comm_budget(served, tag):
    """Each decode step's collectives, by kind, within
    `_decode_comm_budget`; 2x2 uses both axes' collectives."""
    port = served[0]
    for spec in ranks.SERVE_MESHES:
        run = port[f"{spec}/{tag}"]
        for step in run["comm"]:
            assert all(v <= run["budget"].get(k, 0) for k, v in step.items())
        assert run["comm"][0].get("all-gather", 0) > 0
    assert port[f"2x2/{tag}"]["comm"][0].get("all-reduce", 0) > 0
    for step in port["engine_2x2_comm"]:
        assert all(v <= run["budget"].get(k, 0) for k, v in step.items())


def test_plan_guards(served):
    """An indivisible pool or page count raises `ShardingGuardError`, as
    does a local shape the quant_matmul kernel's grid cannot take."""
    port = served[0]
    assert "not divisible" in port["guard_indivisible"]
    assert "n_pages" in port["guard_paged_pages"]
    assert "quant_matmul" in port["guard_kernel"]


TP_TAGS = [t for t, _, b, m in ranks.SERVE_CASES
           if m == ("2x2",) and b != ranks.SPE]


@pytest.mark.parametrize("tag", TP_TAGS)
def test_moe_and_rwkv_tp_mesh_match_reference(served, tag):
    """MoE (olmoe; llama4 with its shared expert) and RWKV-6 (float32 and
    8-bit packed) at model = 2: the prefill's and each decode step's
    logits within F32_REL of the reference's sharded run on 2x2. On a
    data-only mesh they equal the single-device generate."""
    port, ref, built, _ = served
    for t in range(ranks.SERVE_NEW + 1):
        got = port[f"2x2/{tag}"][f"logits/{t}"]
        want = ref["2x2"][f"{tag}/logits/{t}"]
        assert got.shape == want.shape
        assert _rel(got, want) <= F32_REL, (t, _rel(got, want))
    name = built[tag][0].cfg.name
    family = {"olmoe-reduced": "olmoe_1b_7b",
              "rwkv6-reduced": "rwkv6_3b"}.get(name)
    if family is not None:
        assert port[f"data_mesh_{family}"]


@pytest.mark.parametrize("tag", TP_TAGS)
def test_moe_and_rwkv_tp_placed_bytes_and_comm(served, tag):
    """On 2x2: rank 0's placed params and cache hold the plan's bytes to
    the byte (RWKV-6's state replicated over `model`, as the reference's
    `cache_specs` keeps it), and each decode step's collectives stay
    within `_decode_comm_budget`, all-reduces and all-gathers both."""
    run = served[0][f"2x2/{tag}"]
    placed_p, plan_p, placed_c, plan_c = run["bytes"]
    assert placed_p == plan_p and placed_c == plan_c
    for step in run["comm"]:
        assert all(v <= run["budget"].get(k, 0) for k, v in step.items())
        assert step.get("all-reduce", 0) > 0 and step.get("all-gather", 0) > 0


@pytest.mark.parametrize("tag", SPE_TAGS)
def test_spe_tp_mesh_matches_reference(served, tag):
    """The SPE tree at model = 2 (column-parallel linears on their local
    values, selects and scales; row-parallel ones on their blocks of
    whole compressed groups through `nm_spmm`, the partials summed): the
    prefill's and each decode step's logits within F32_REL of the
    reference's sharded run of the same weights on 2x2, and
    `sharded_generate` its greedy tokens."""
    port, ref, _, _ = served
    for t in range(ranks.SERVE_NEW + 1):
        got = port[f"2x2/{tag}"][f"logits/{t}"]
        want = ref["2x2"][f"{tag}/logits/{t}"]
        assert got.shape == want.shape
        assert _rel(got, want) <= F32_REL, (t, _rel(got, want))
    np.testing.assert_array_equal(port[f"2x2/{tag}/generate"],
                                  ref["2x2"][f"{tag}/generate"])


@pytest.mark.parametrize("tag", SPE_TAGS)
def test_spe_tp_placed_bytes_and_comm(served, tag):
    """On 2x2 the SPE tree places as a packed one: rank 0's params and
    cache hold the plan's bytes to the byte, and each decode step's
    collectives stay within `_decode_comm_budget`, all-reduces (the row
    blocks' partials) and all-gathers both."""
    run = served[0][f"2x2/{tag}"]
    placed_p, plan_p, placed_c, plan_c = run["bytes"]
    assert placed_p == plan_p and placed_c == plan_c
    for step in run["comm"]:
        assert all(v <= run["budget"].get(k, 0) for k, v in step.items())
        assert step.get("all-reduce", 0) > 0 and step.get("all-gather", 0) > 0


def test_spe_row_block_that_cuts_a_group_raises(served):
    """At model = 8 the reduced qwen3's attention output (32 compressed
    rows, 8 a group) leaves each rank 4: `plan_decode` raises, naming the
    leaf; at model = 4 (8 rows, one group) it plans."""
    from repro_torch.dist import sharding as tshd
    from repro_torch.serve import sharded as TSH

    model, params = served[2][SPE_TAGS[0]]
    with pytest.raises(tshd.ShardingGuardError, match="wo/values_q"):
        TSH.plan_decode(model, params,
                        tshd.MeshShape(("data", "model"), (1, 8)),
                        batch_size=8)
    tshd.check_row_groups(
        params, tshd.param_specs(params, model.cfg, tshd.MeshShape(
            ("data", "model"), (1, 4))),
        tshd.MeshShape(("data", "model"), (1, 4)),
        lambda node: node["meta"]["keep"] if "values_q" in node else None,
        "plan")


@pytest.mark.parametrize("name,spec", ranks.ADMISSION_CASES)
def test_sharded_engine_matches_sharded_generate_under_interleavings(
        served, name, spec):
    """ShardedEngine (a pool of 8; batched sharded prefill admission,
    scatter seating, recurrent caches included) under two seeded random
    interleavings of 4 requests, each request's tokens equal to
    `sharded_generate`'s on the same mesh, token for token; every request
    done and the pool drained."""
    port = served[0]
    for seed in ranks.ADMISSION_SEEDS:
        run = port[f"admission/{name}/{spec}/{seed}"]
        assert run["done"] and run["drained"], (seed, run["steps"])
        assert run["outputs"] == run["want"], seed


def test_constrain_and_place(served):
    port = served[0]
    assert port["constrain_ok"] and "implies 2" in port["constrain_refused"]
    assert port["place"]


def test_launch_serve_mesh_main(served):
    """launch.serve --mesh 2x2 on 4 ranks through `main`: the
    single-device run's tokens, placed bytes equal to the plan's, each
    decode step within the budget."""
    rec = served[0]["launch_2x2"]
    want = tlaunch.main(["--arch", "qwen3-8b", "--reduced", "--quant-bits",
                         "8", "--max-new", "6"], device="cpu")
    assert rec["tokens"] == want["tokens"]
    assert rec["backend"] == "gloo" and rec["world"] == 4
    assert rec["param_bytes_placed"] == rec["param_bytes_per_device"]
    assert rec["cache_bytes_placed"] == rec["cache_bytes_per_device"]
    assert rec["param_bytes_per_device"] < rec["param_bytes_total"]
    for step in rec["decode_comm"]:
        assert all(v <= rec["comm_budget"][k] for k, v in step.items())


def test_serve_lm_example_sharded_block(served):
    port = served[0]
    sharded = port["example_sharded"]
    assert sharded["n_devices"] == 4 and sharded["same"]
    assert sharded["outputs"] == port["example_outputs"]


def test_mesh_refusals(capsys):
    """--mesh with --connect (the client; the server takes the mesh), and
    va-cnn over a mesh, are refused."""
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "qwen3-8b", "--reduced", "--mesh", "2",
                      "--connect", "127.0.0.1:1"], device="cpu")
    assert "--listen --mesh" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "va-cnn", "--mesh", "2"], device="cpu")

"""The port's side of the multi-rank tests: functions that every rank of
a spawned gloo group runs (`launch._spawn.run`), importing torch and the
port only. Each returns, on rank 0, numpy arrays and flags for the test
to check; the other ranks return None.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, convert, optim
from repro_torch._tree import leaves, tree_map
from repro_torch.dist import compression as C
from repro_torch.launch import _spawn
from repro_torch.launch.mesh import (
    make_data_mesh,
    make_multipod_mesh,
    make_smoke_mesh,
)
from repro_torch.models import api
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault, trainer

MULTIPOD_MODES = (("gather", True), ("two_stage", True), ("f32", False))
STEPS = 3


def _all_ranks_true(ok: bool) -> bool:
    flag = torch.tensor([0 if ok else 1])
    dist.all_reduce(flag)
    return int(flag) == 0


def _stack_over(group, x: torch.Tensor) -> np.ndarray:
    """(n, *x.shape): every rank's `x`, in group order."""
    n = dist.get_world_size(group)
    out = torch.empty(n * x.numel(), dtype=x.dtype)
    dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(), group=group)
    return out.reshape((n,) + tuple(x.shape)).numpy()


def compression(data: dict) -> dict | None:
    """The reduction cases of `_dist_reference.compression` on ranks
    [0, n) for n in (2, 4), with the wire counts of one call each."""
    out: dict = {}
    names = sorted(k for k in data if k.startswith("l"))
    for n in (2, 4):
        mesh = make_multipod_mesh(f"{n}x1", "cpu")
        if mesh.get_coordinate() is None:
            continue
        group, p = mesh.get_group("pod"), mesh.get_local_rank("pod")
        g = {k: torch.from_numpy(data[k][p].copy()) for k in names}
        e = tree_map(torch.zeros_like, g)
        e1 = tree_map(torch.zeros_like, g)
        e2 = {k: torch.zeros(C.two_stage_shard_len(v.numel(), n))
              for k, v in g.items()}
        for step in range(2):
            C.reset_wire()
            m, e = C.compressed_psum_mean(g, e, group)
            if step == 0:
                out[f"n{n}/gather/wire"] = dict(C.wire_bytes)
            for k in names:
                out[f"n{n}/gather/mean{step}/{k}"] = m[k].numpy()
                out[f"n{n}/gather/err{step}/{k}"] = _stack_over(group, e[k])
            C.reset_wire()
            m, e1, e2 = C.two_stage_psum_mean(g, e1, e2, group)
            if step == 0:
                out[f"n{n}/two_stage/wire"] = dict(C.wire_bytes)
            for k in names:
                out[f"n{n}/two_stage/mean{step}/{k}"] = m[k].numpy()
                out[f"n{n}/two_stage/err1_{step}/{k}"] = _stack_over(
                    group, e1[k])
                out[f"n{n}/two_stage/err2_{step}/{k}"] = _stack_over(
                    group, e2[k])
        for guard in (True, False):
            C.reset_wire()
            m = C.uncompressed_psum_mean(g, group, finite_guard=guard)
            tag = "" if guard else "_raw"
            out[f"n{n}/uncompressed{tag}/wire"] = dict(C.wire_bytes)
            for k in names:
                out[f"n{n}/uncompressed{tag}/mean0/{k}"] = m[k].numpy()
    return out if _spawn.rank() == 0 else None


def _lm():
    """The reduced qwen3-8b in float32, as `_dist_reference` runs it."""
    cfg = dataclasses.replace(configs.reduced("qwen3_8b"), dtype="float32")
    return cfg, api.build_model(cfg, tp=1, max_seq=32)


def _state(model, params_np, mesh, scheme, compress):
    opt = optim.adamw(3e-3)
    params = convert.lm_params_from_numpy(params_np, device="cpu")
    state = trainer.init_state(params, opt, device="cpu")
    state["err"] = trainer.init_dp_err(state["params"], mesh, scheme=scheme,
                                       compress=compress)
    return opt, state


def _multipod_steps(params_np, batches, ckpt_dir, out) -> None:
    """3 steps of each mode at 2 and 4 pods from the reference's params
    and batches; the global state (the checkpoint layout) of each; the
    4-pod two_stage state checkpointed and restored."""
    cfg, model = _lm()
    for n in (2, 4):
        mesh = make_multipod_mesh(f"{n}x1", "cpu")
        if mesh.get_coordinate() is None:
            continue
        for mode, compress in MULTIPOD_MODES:
            scheme = mode if compress else "gather"
            opt, state = _state(model, params_np, mesh, scheme, compress)
            step, shardings = trainer.make_multipod_train_step(
                model.loss, opt, cfg, mesh, state, scheme=scheme,
                compress=compress)
            for i, b in enumerate(batches):
                state, m = step(state, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
                for k, v in m.items():
                    out[f"n{n}/{mode}/metrics/{k}/{i}"] = float(v)
                if i == 0:
                    first = ckpt._flatten({"err": state["err"]},
                                          {"err": shardings["err"]})
                    for k, v in first.items():
                        out[f"n{n}/{mode}/step0/{k}"] = v
            flat = ckpt._flatten(state, shardings)
            for k, v in flat.items():
                out[f"n{n}/{mode}/state/{k}"] = v
            if n == 4 and mode == "two_stage":
                path = ckpt.save(state, ckpt_dir, STEPS, shardings=shardings)
                like = tree_map(torch.zeros_like, state)
                back, s = ckpt.restore(ckpt_dir, like, shardings=shardings)
                same = s == STEPS and all(
                    torch.equal(a, b)
                    for a, b in zip(leaves(state), leaves(back)))
                out["ckpt_path"] = path
                out["ckpt_restored_bitwise"] = _all_ranks_true(same)
                # a 2-pod state cannot take the 4-pod checkpoint
                mesh2 = make_multipod_mesh("2x1", "cpu")
                refused = True
                if mesh2.get_coordinate() is not None:
                    _, st2 = _state(model, params_np, mesh2, scheme, True)
                    _, sh2 = trainer.make_multipod_train_step(
                        model.loss, opt, cfg, mesh2, st2, scheme=scheme)
                    try:
                        ckpt.restore(ckpt_dir, st2, shardings=sh2)
                        refused = False
                    except ValueError:
                        pass
                out["ckpt_other_pod_count_refused"] = refused


def _runs_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def _kill_resume(tmp: str, out) -> None:
    """The port against itself at 2 pods (two_stage): an interrupted
    run resumed from its checkpoint, and a run with a fault injected on
    every rank, each against the uninterrupted run."""
    from repro_torch.data import lm

    cfg, model = _lm()
    mesh = make_multipod_mesh("2x1", "cpu")
    if mesh.get_coordinate() is None:
        out_ok = True
    else:
        params_np = tree_map(lambda p: p.numpy(), model.init(0, device="cpu"))
        opt, state0 = _state(model, params_np, mesh, "two_stage", True)
        step, sh = trainer.make_multipod_train_step(
            model.loss, opt, cfg, mesh, state0, scheme="two_stage")
        stream = lm.TokenStream(batch=8, seq_len=16, vocab=cfg.vocab,
                                seed=0, device="cpu")
        fresh = lambda: tree_map(torch.clone, state0)  # noqa: E731
        d1, d2, d3 = (os.path.join(tmp, x) for x in "abc")
        kw = dict(ckpt_every=3, log_every=0, restore_shardings=sh)
        final1, hist1 = fault.run_training(
            step, fresh(), stream.batch_at, num_steps=8, ckpt_dir=d1, **kw)
        fault.run_training(
            step, fresh(), stream.batch_at, num_steps=5, ckpt_dir=d2, **kw)
        final2, hist2 = fault.run_training(
            step, fresh(), stream.batch_at, num_steps=8, ckpt_dir=d2, **kw)
        injector = fault.FaultInjector(fail_at={5})
        final3, hist3 = fault.run_training(
            step, fresh(), stream.batch_at, num_steps=8, ckpt_dir=d3,
            fault_hook=injector, **kw)
        out_ok = (
            hist2[0]["step"] == 5
            and [h["loss"] for h in hist1 if h["step"] >= 5]
            == [h["loss"] for h in hist2]
            and _runs_equal(final1, final2)
            and injector.failures == 1 and int(final3["step"]) == 8
            and hist3[-1]["step"] == 7 and _runs_equal(final1, final3)
            and len(hist1) == 8
        )
        out["kill_resume_losses"] = [h["loss"] for h in hist1]
    out["kill_resume_bitwise"] = _all_ranks_true(out_ok)


def _fleet(out) -> None:
    """FleetRunner on the 4-rank data mesh against the unsharded runner,
    on both paths; the sharding check; an indivisible bucket refused."""
    from repro_torch.benchmarks import stream_throughput as ST
    from repro_torch.core import compiler, vadetect
    from repro_torch.stream import FleetRunner

    params = vadetect.init(torch.Generator().manual_seed(0), device="cpu")
    program = compiler.compile_model(params)
    mesh = make_data_mesh(4, "cpu")
    x = np.random.default_rng(3).standard_normal((32, 512)).astype(np.float32)
    same = True
    for path in ("twin", "kernel"):
        one = FleetRunner(program, path=path, device="cpu")
        four = FleetRunner(program, path=path, device="cpu", mesh=mesh)
        for b in (8, 32):
            same &= torch.equal(one.classify(x[:b]), four.classify(x[:b]))
        out[f"fleet_{path}_n_devices"] = four.n_devices
    out["fleet_same_predictions"] = _all_ranks_true(same)
    out["fleet_sharding_verified"] = ST._verify_batch_sharding(four, 32, 4)
    try:
        four.classify(x[:6])
        out["fleet_indivisible_refused"] = False
    except ValueError:
        out["fleet_indivisible_refused"] = True
    cells, scaling = ST.sweep(program, [8, 32], ST.device_counts(False),
                              patients=8, segments=2, device="cpu")
    out["sweep_cells"] = cells
    out["sweep_scaling"] = scaling


def _entry_points(out) -> None:
    """launch.train --multi-pod and launch.stream --devices through
    `main`, inside this group (the launcher uses the ranks that are
    here)."""
    from repro_torch.launch import stream as launch_stream
    from repro_torch.launch import train as launch_train

    base = ["--arch", "qwen3-8b", "--reduced", "--steps", "3", "--batch",
            "8", "--seq", "16", "--log-every", "0"]
    for spec, extra in (("4x1", ["--scheme", "two_stage"]),
                        ("2x1", ["--no-compress"])):
        rec = launch_train.main([*base, "--multi-pod", spec, *extra],
                                device="cpu")
        if rec is not None:
            out[f"train_{spec}_losses"] = [h["loss"] for h in rec["history"]]
            out[f"train_{spec}_err_keys"] = sorted(rec["state"]["err"])
    rec = launch_stream.main(["--devices", "4", "--patients", "16",
                              "--segments", "4", "--path", "kernel"],
                             device="cpu")
    if rec is not None:
        out["stream_devices"] = rec["config"]["n_devices"]
        out["stream_metrics"] = {k: rec["metrics"][k] for k in (
            "segments_total", "dropped_total", "batches_total")}
        out["stream_chip"] = rec["chip"]


def multipod(params_np: dict, batches: list, tmp: str) -> dict | None:
    """The multi-pod steps held against the reference, and the
    checkpoint of their error buffers, on 4 ranks."""
    out: dict = {}
    _multipod_steps(params_np, batches, os.path.join(tmp, "ckpt"), out)
    return out if _spawn.rank() == 0 else None


def port_only(tmp: str) -> dict | None:
    """The checks of the port against itself on 4 ranks: kill and
    resume, the sharded fleet and its sweep, the entry points."""
    out: dict = {}
    _kill_resume(tmp, out)
    _fleet(out)
    _entry_points(out)
    return out if _spawn.rank() == 0 else None


# ---------------------------------------------------------------------------
# Sharded serving (serve.sharded) on ("data", "model") meshes
# ---------------------------------------------------------------------------

SERVE_CASES = (("qwen3", "qwen3_8b", 0), ("qwen3_q8", "qwen3_8b", 8),
               ("rg", "recurrentgemma_2b", 0))
SERVE_MESHES = ("4x1", "2x2")
SERVE_B, SERVE_S, SERVE_NEW = 8, 6, 6
SERVE_MAX_SEQ = SERVE_S + SERVE_NEW + 2
SAMPLE_KEY = (7,)
PAGE, N_PAGES = 4, 16  # tests/test_paged_properties.py's pool, per shard
PROMPT_LENS = (2, 3, 5, 9)


def serve_model(name: str, max_seq: int = SERVE_MAX_SEQ):
    """A reduced config in float32, as `_dist_reference.decode` builds it."""
    cfg = dataclasses.replace(configs.reduced(name), dtype="float32")
    return api.build_model(cfg, tp=1, max_seq=max_seq)


def serve_requests(cfg, n: int, max_new: int = 5, seed: int = 100) -> list:
    """n requests of 4 seeded tokens each (tests/test_decode_multidevice.py's
    `_requests`, drawn with numpy)."""
    from repro_torch.serve import engine as E

    return [E.Request(uid=i, prompt=torch.from_numpy(
        np.random.default_rng(seed + i).integers(0, cfg.vocab, 4)),
        max_new=max_new) for i in range(n)]


def paged_requests(cfg) -> list:
    """tests/test_paged_properties.py's 12 requests of mixed lengths."""
    from repro_torch.serve import engine as E

    rng = np.random.default_rng(3)
    return [E.Request(uid=i, prompt=torch.from_numpy(
        np.random.default_rng(1000 + i).integers(
            0, cfg.vocab, int(rng.choice(PROMPT_LENS)))),
        max_new=int(rng.integers(2, 5))) for i in range(12)]


def _delta(before: dict) -> dict:
    from repro_torch.dist import sharding as shd

    return {k: v - before.get(k, 0) for k, v in shd.comm_calls.items()
            if v != before.get(k, 0)}


def _decode_run(model, params, prompts, mesh, new: int) -> dict:
    """`_dist_reference.decode`'s loop on the port: the plan, this rank's
    block of the params, prefill and greedy decode steps on its rows; the
    logits and tokens gathered over `data`, each step's collectives, and
    the bytes this rank holds against the plan's."""
    from repro_torch.dist import sharding as shd
    from repro_torch.serve import sharded as SH

    b, s = prompts.shape
    plan = SH.plan_decode(model, params, mesh, batch_size=b)
    prefill, step = SH.compile_decode(model, plan)
    placed = SH.place_params(params, plan)
    lo, hi = plan.rows

    def whole(x):
        return (shd.all_gather(x, plan.groups.data, 0) if plan.n_data > 1
                else x).numpy()

    logits, cache = prefill(placed, prompts[lo:hi])
    out = {"logits/0": whole(logits),
           "bytes": [shd.placed_bytes(placed), plan.param_bytes_per_device,
                     shd.placed_bytes(cache), plan.cache_bytes_per_device]}
    tok = torch.argmax(logits, dim=-1)
    toks, comm = [], []
    for t in range(new):
        toks.append(tok)
        pos = torch.full((hi - lo,), s + t, dtype=torch.long)
        before = dict(shd.comm_calls)
        logits, cache = step(placed, cache, tok, pos)
        comm.append(_delta(before))
        out[f"logits/{t + 1}"] = whole(logits)
        tok = torch.argmax(logits, dim=-1)
    out["tokens"] = whole(torch.stack(toks, dim=1))
    out["comm"] = comm
    out["budget"] = SH._decode_comm_budget(model)
    return out


def _engines(out: dict) -> None:
    """ShardedEngine on the 4x1 mesh: three requests into a pool of 8,
    EOS on the first token, the paged pool (with and without chunked
    prefill) against the dense sharded pool with every mapped page on
    its slot's shard, the cache bytes against the plan, and the
    collectives of a decode step at 2x2."""
    from repro_torch.serve import engine as E
    from repro_torch.serve import sharded as SH
    from repro_torch.serve.paging import PagingConfig
    from repro_torch.dist import sharding as shd

    model = serve_model("qwen3_8b", max_seq=96)
    params = model.init(0, device="cpu")
    mesh = make_smoke_mesh(4, 1, "cpu")
    eng = SH.ShardedEngine(model, params, batch_size=8, mesh=mesh,
                           device="cpu")
    reqs = serve_requests(model.cfg, 3)
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=50)
    out["engine_outputs"] = [r.output for r in reqs]
    out["engine_done"] = all(r.done for r in reqs)
    out["engine_drained"] = (all(s is None for s in eng._slots)
                             and not bool(eng.active.any()))
    out["engine_cache_bytes"] = [shd.placed_bytes(eng.cache),
                                 eng.cache_bytes_per_device]

    prompt = torch.from_numpy(np.random.default_rng(9).integers(
        0, model.cfg.vocab, 4))
    probe = E.Request(uid=0, prompt=prompt, max_new=2)
    eng = SH.ShardedEngine(model, params, batch_size=8, mesh=mesh,
                           device="cpu")
    eng.submit(probe)
    eng.tick()
    first = probe.output[0]
    eng = SH.ShardedEngine(model, params, batch_size=8, mesh=mesh,
                           device="cpu")
    eos_req = E.Request(uid=1, prompt=prompt, max_new=8, eos=first)
    tail = E.Request(uid=2, prompt=prompt, max_new=3)
    eng.submit(eos_req)
    eng.submit(tail)
    eng.run(max_ticks=30)
    out["eos"] = {"first": first, "eos_output": eos_req.output,
                  "eos_done": eos_req.done, "tail_done": tail.done,
                  "tail_len": len(tail.output),
                  "drained": all(s is None for s in eng._slots)}

    paging = PagingConfig(page_size=PAGE, n_pages=4 * N_PAGES)
    for label, kw in (("dense", {}), ("paged", {"paging": paging}),
                      ("paged_chunked", {"paging": paging,
                                         "chunk_tokens": 4})):
        reqs = paged_requests(model.cfg)
        eng = SH.ShardedEngine(model, params, batch_size=8, mesh=mesh,
                               device="cpu", **kw)
        for r in reqs:
            eng.submit(r)
        on_shard = True
        for _ in range(60):
            n = eng.tick()
            if eng._pg is not None:
                per = eng._pg.per_shard
                for slot in range(eng.batch):
                    shard = eng._slot_shard(slot)
                    on_shard &= all(
                        per * shard <= p < per * (shard + 1)
                        for p in eng._tbl[slot][: eng._npages[slot]])
            if n == 0 and not eng._queue:
                break
        rec = {"outputs": [r.output for r in reqs],
               "done": all(r.done for r in reqs), "on_shard": on_shard,
               "cache_bytes": [shd.placed_bytes(eng.cache),
                               eng.cache_bytes_per_device]}
        if eng._pg is not None:
            eng._pg.check_invariants()
            rec["allocated_after"] = eng._pg.allocated_pages()
        out[f"pool_{label}"] = rec

    mesh22 = make_smoke_mesh(2, 2, "cpu")
    eng = SH.ShardedEngine(model, params, batch_size=8, mesh=mesh22,
                           device="cpu")
    reqs = serve_requests(model.cfg, 3)
    for r in reqs:
        eng.submit(r)
    comm = []
    while eng.tick():
        comm.append(dict(eng.last_step_comm))
    out["engine_2x2_outputs"] = [r.output for r in reqs]
    out["engine_2x2_comm"] = comm
    out["engine_2x2_cache_bytes"] = [shd.placed_bytes(eng.cache),
                                     eng.cache_bytes_per_device]


def _guards(out: dict) -> None:
    """What plan_decode refuses: an indivisible pool, tensor parallelism
    for MoE and RWKV-6, a local shape the quant_matmul kernel cannot
    take; and constrain on a wrong local shape."""
    from repro_torch.dist import sharding as shd
    from repro_torch.serve import engine as E
    from repro_torch.serve import sharded as SH
    from repro_torch.serve.paging import PagingConfig

    model = serve_model("qwen3_8b")
    params = model.init(0, device="cpu")
    mesh = make_smoke_mesh(4, 1, "cpu")
    mesh22 = make_smoke_mesh(2, 2, "cpu")

    def refused(fn, exc):
        try:
            fn()
        except exc as e:
            return str(e)
        return None

    out["guard_indivisible"] = refused(
        lambda: SH.plan_decode(model, params, mesh, batch_size=6),
        shd.ShardingGuardError)
    out["guard_paged_pages"] = refused(
        lambda: SH.plan_decode(model, params, mesh, batch_size=8,
                               paging=PagingConfig(2, 18)),
        shd.ShardingGuardError)
    packed = E.quantize_for_serving(params, 8)
    out["guard_kernel"] = refused(
        lambda: SH.plan_decode(model, packed, mesh,
                               batch_size=4 * 65535 * 64 + 4 * 64),
        shd.ShardingGuardError)
    for name in ("olmoe_1b_7b", "rwkv6_3b"):
        m = serve_model(name)
        p = m.init(0, device="cpu")
        out[f"guard_tp_{name}"] = refused(
            lambda m=m, p=p: SH.plan_decode(m, p, mesh22, batch_size=8),
            NotImplementedError)
        prompts = torch.from_numpy(np.random.default_rng(5).integers(
            0, m.cfg.vocab, (SERVE_B, 4)))
        got = SH.sharded_generate(m, p, prompts, mesh=mesh, max_new=3)
        want = E.generate(m, p, prompts, max_new=3, device="cpu")
        out[f"data_mesh_{name}"] = bool(torch.equal(got, want))
    with shd.activation_context(model.cfg, mesh22):
        x = torch.zeros((2, 3, 4, 16))
        out["constrain_ok"] = shd.constrain(
            x[:, :, :2], "dp", None, "tp", None,
            shape=(None, None, 4, 16)) is not None
        out["constrain_refused"] = refused(
            lambda: shd.constrain(x, "dp", None, "tp", None,
                                  shape=(None, None, 4, 16)),
            shd.ShardingGuardError)


def _placement(out: dict) -> None:
    """place: a split leaf's block is its own contiguous copy, an unsplit
    leaf is kept as it is."""
    from repro_torch.dist import sharding as shd

    mesh = make_smoke_mesh(2, 2, "cpu")
    tree = {"a": torch.arange(32.).reshape(4, 8), "b": torch.ones(3)}
    specs = {"a": ("data", "model"), "b": (None,)}
    got = shd.place(tree, specs, mesh)
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    a = got["a"]
    ok = (torch.equal(a, tree["a"][2 * d:2 * d + 2, 4 * m:4 * m + 4])
          and a.is_contiguous()
          and a.untyped_storage().data_ptr()
          != tree["a"].untyped_storage().data_ptr()
          and got["b"] is tree["b"])
    out["place"] = _all_ranks_true(bool(ok))


def _entry(out: dict) -> None:
    """launch.serve --mesh 2x2 and the serve_lm example's sharded block,
    through `main`, in this group."""
    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve as launch_serve

    rec = launch_serve.main(["--arch", "qwen3-8b", "--reduced", "--mesh",
                             "2x2", "--quant-bits", "8", "--max-new", "6"],
                            device="cpu")
    if rec is not None:
        rec.pop("placed")
        out["launch_2x2"] = rec
    demo = serve_lm.main(["--smoke"], device="cpu")
    out["example_sharded"] = demo["sharded"]
    out["example_outputs"] = demo["outputs"]


def serving(inputs: dict) -> dict | None:
    """The port's sharded serving on 4 ranks: each case's prefill and
    decode logits and tokens on 4x1 and 2x2 (for the reference's), the
    sampled generate on 4x1, the engines, the guards, placement and the
    entry points."""
    from repro_torch.serve import sharded as SH

    out: dict = {}
    prompts = torch.from_numpy(inputs["prompts"])
    for tag, name, _ in SERVE_CASES:
        model = serve_model(name)
        params = convert.lm_params_from_numpy(inputs["params"][tag], "cpu")
        for spec in SERVE_MESHES:
            mesh = make_smoke_mesh(*(int(x) for x in spec.split("x")), "cpu")
            out[f"{spec}/{tag}"] = _decode_run(model, params, prompts, mesh,
                                               SERVE_NEW)
            out[f"{spec}/{tag}/generate"] = SH.sharded_generate(
                model, params, prompts, mesh=mesh,
                max_new=SERVE_NEW).numpy()
        if tag == "qwen3":
            out["4x1/qwen3/sampled"] = SH.sharded_generate(
                model, params, prompts, mesh=make_smoke_mesh(4, 1, "cpu"),
                max_new=SERVE_NEW, greedy=False, key=SAMPLE_KEY,
                temperature=0.8, top_k=20).numpy()
    _engines(out)
    _guards(out)
    _placement(out)
    _entry(out)
    return out if _spawn.rank() == 0 else None

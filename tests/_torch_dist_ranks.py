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


def stream_listen_recorded(argv: list, out_path: str) -> None:
    """`launch.stream.main(argv)` (a `--listen --devices N` server) on
    this rank of the group, until SIGINT; every bucket this rank's
    `FleetRunner.classify` returns is kept with its signals, and rank 0
    saves them (with its runner's device count) to `out_path`."""
    from repro_torch.launch import stream as launch_stream
    from repro_torch.stream import runner as R

    seen, n_devices = [], []
    classify = R.FleetRunner.classify

    def recorded(self, signals):
        preds = classify(self, signals)
        seen.append((torch.as_tensor(signals, dtype=torch.float32).clone(),
                     preds.clone()))
        n_devices.append(self.n_devices)
        return preds

    R.FleetRunner.classify = recorded
    launch_stream.main(argv, device="cpu")
    if _spawn.rank() == 0:
        torch.save({"seen": seen, "n_devices": n_devices[-1]}, out_path)


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

SERVE_MESHES = ("4x1", "2x2")
SPE = "spe8"  # the SPE serving format: 16:8, 8 bits
# tag, config, format (packed bits, 0: float32, or SPE:
# `_spe_tree.sparse_for_serving`), the meshes it is held on: MoE (llama4
# with its shared expert), RWKV-6 and the SPE linears at model = 2
SERVE_CASES = (("qwen3", "qwen3_8b", 0, SERVE_MESHES),
               ("qwen3_q8", "qwen3_8b", 8, SERVE_MESHES),
               ("rg", "recurrentgemma_2b", 0, SERVE_MESHES),
               ("olmoe", "olmoe_1b_7b", 0, ("2x2",)),
               ("llama4", "llama4_scout_17b_a16e", 0, ("2x2",)),
               ("rwkv", "rwkv6_3b", 0, ("2x2",)),
               ("rwkv_q8", "rwkv6_3b", 8, ("2x2",)),
               ("qwen3_spe", "qwen3_8b", SPE, ("2x2",)))
# the reference's processes (tests/_dist_reference.py decode): mesh, tags
SERVE_REF_PROCS = (("4x1", "qwen3,qwen3_q8,rg"),
                   ("2x2", "qwen3,qwen3_q8,rg,qwen3_spe"),
                   ("2x2", "olmoe,llama4,rwkv,rwkv_q8"))
# tests/test_admission_properties.py's sharded property: config, mesh;
# its interleavings drawn from these seeds (its max_examples=2)
ADMISSION_CASES = (("qwen3_8b", "4x1"), ("recurrentgemma_2b", "4x1"),
                   ("qwen3_8b", "2x2"), ("olmoe_1b_7b", "2x2"))
ADMISSION_SEEDS = (0, 1)
ADMISSION_MAX_SEQ = 24
ADMISSION_PROMPT_LENS = (2, 3, 4)
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
    EOS on the first token, the paged pools of qwen3 and recurrentgemma
    (`_paged_pools`), the cache bytes against the plan, and the
    collectives of a decode step at 2x2."""
    from repro_torch.serve import engine as E
    from repro_torch.serve import sharded as SH
    from repro_torch.dist import sharding as shd

    model = serve_model("qwen3_8b", max_seq=96)
    params = model.init(0, device="cpu")
    mesh = make_smoke_mesh(4, 1, "cpu")
    _paged_pools(out, "", model, params, mesh)
    rg = serve_model("recurrentgemma_2b", max_seq=96)
    _paged_pools(out, "rg_", rg, rg.init(0, device="cpu"), mesh)
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


def _paged_pools(out: dict, prefix: str, model, params, mesh) -> None:
    """tests/test_paged_properties.py's 12 requests through ShardedEngine
    pools of 8 on `mesh`: dense, paged and paged with chunked prefill,
    each pool's outputs, every mapped page on its slot's shard, the
    cache bytes against the plan, nothing left allocated."""
    from repro_torch.dist import sharding as shd
    from repro_torch.serve import sharded as SH
    from repro_torch.serve.paging import PagingConfig

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
        out[f"pool_{prefix}{label}"] = rec


def _guards(out: dict) -> None:
    """What plan_decode refuses: an indivisible pool, a local shape the
    quant_matmul kernel cannot take; MoE and RWKV-6 on a data-only mesh
    against one device; and constrain on a wrong local shape."""
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


def admission_requests(cfg, rng, n: int) -> list:
    """tests/test_admission_properties.py's `_make_requests` (no EOS),
    the prompts drawn with numpy."""
    from repro_torch.serve import engine as E

    reqs = []
    for i in range(n):
        s_len = int(rng.choice(ADMISSION_PROMPT_LENS))
        prompt = torch.from_numpy(np.random.default_rng(1000 + i).integers(
            0, cfg.vocab, s_len))
        reqs.append(E.Request(uid=i, prompt=prompt,
                              max_new=int(rng.integers(1, 5))))
    return reqs


def drive_random_interleaving(eng, reqs, rng, max_steps: int = 200) -> int:
    """tests/test_admission_properties.py's `_drive_random_interleaving`:
    submit 1-2 pending requests with probability 0.6 (always when the
    queue is empty), then tick, until drained. Returns the ticks."""
    pending = list(reqs)
    steps = 0
    while (pending or eng._queue
           or any(s is not None for s in eng._slots)) and steps < max_steps:
        steps += 1
        if pending and (rng.random() < 0.6 or not eng._queue):
            for _ in range(int(rng.integers(1, 3))):
                if pending:
                    eng.submit(pending.pop(0))
        eng.tick()
    return steps


def _admission(out: dict) -> None:
    """The twin of test_sharded_engine_matches_sharded_generate_under_
    interleavings: for each case and seed, ShardedEngine (a pool of 8)
    under a seeded interleaving of 4 requests, each request's output
    against `sharded_generate` on the same mesh of its prompt broadcast
    over 8 rows (row 0 read), token for token."""
    from repro_torch.serve import sharded as SH

    for name, spec in ADMISSION_CASES:
        model = serve_model(name, max_seq=ADMISSION_MAX_SEQ)
        params = model.init(0, device="cpu")
        mesh = make_smoke_mesh(*(int(x) for x in spec.split("x")), "cpu")
        plan = SH.plan_decode(model, params, mesh, batch_size=8)
        placed = SH.place_params(params, plan)
        for seed in ADMISSION_SEEDS:
            rng = np.random.default_rng(seed)
            reqs = admission_requests(model.cfg, rng, 4)
            eng = SH.ShardedEngine(model, params, batch_size=8, mesh=mesh,
                                   device="cpu")
            steps = drive_random_interleaving(eng, reqs, rng)
            want = [SH.sharded_generate(
                model, placed, r.prompt[None].expand(8, -1), mesh=mesh,
                max_new=r.max_new, params_placed=True, plan=plan,
            )[0].tolist() for r in reqs]
            out[f"admission/{name}/{spec}/{seed}"] = {
                "outputs": [r.output for r in reqs], "want": want,
                "done": all(r.done for r in reqs), "steps": steps,
                "drained": (all(s is None for s in eng._slots)
                            and not bool(eng.active.any()))}


def serving(inputs: dict) -> dict | None:
    """The port's sharded serving on 4 ranks: each case's prefill and
    decode logits and tokens on its meshes (for the reference's), the
    sampled generate on 4x1, the engines, the admission property, the
    guards, placement and the entry points."""
    from repro_torch.serve import sharded as SH

    out: dict = {}
    prompts = torch.from_numpy(inputs["prompts"])
    for tag, name, _, meshes in SERVE_CASES:
        model = serve_model(name)
        params = convert.lm_params_from_numpy(inputs["params"][tag], "cpu")
        for spec in meshes:
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
    _admission(out)
    _guards(out)
    _placement(out)
    _entry(out)
    return out if _spawn.rank() == 0 else None


# ---------------------------------------------------------------------------
# Training over data and model (make_multipod_train_step at D·M > 1,
# make_sharded_train_step)
# ---------------------------------------------------------------------------

# tag, config, mode (gather | two_stage | f32), step, mesh, reference
# process (tests/_dist_reference.py inpod), warm-up steps: the held steps
# start from the state that many steps on one process leave (the
# batches after them), else from the draw
INPOD_CASES = (
    ("qwen3_f32", "qwen3_8b", "f32", "multipod", "1x2x2", "a", 0),
    ("qwen3_sharded", "qwen3_8b", "f32", "sharded", "2x2", "a", 0),
    ("rg_f32", "recurrentgemma_2b", "f32", "multipod", "1x2x2", "b", 3),
    ("qwen3_gather", "qwen3_8b", "gather", "multipod", "2x2x1", "c", 0),
    ("qwen3_two_stage", "qwen3_8b", "two_stage", "multipod", "2x1x2", "d",
     0),
    ("olmoe_f32", "olmoe_1b_7b", "f32", "multipod", "1x4x1", "e", 0),
)
TRAIN_COMM_ENVELOPE = 512  # the reference's _TRAIN_COMM_ENVELOPE, a kind

# The families beside them (tests/test_torch_inpod_families.py), all in
# float32 through the multi-pod step from the draw: tag, config, mesh,
# reference process, the config fields the case overrides (a dict; the
# reference reads its repr) and the steps it runs. Each case has its own
# batches (whisper's carry frames).
#
# rwkv6 runs one step. The reduced rwkv6 in float32 at AdamW 3e-3 is
# ill-conditioned: `u` carries a gradient norm of ~1300 at the draw, so
# clipping leaves every other leaf's gradient near Adam's eps, and the
# forward amplifies a reordered sum's rounding a thousandfold within a
# step or two. The reference does not hold its own 1x1x1 and 1x2x2
# layouts to the 1e-4 bound past one step, from the draw or from a warm
# state (`python tests/_dist_reference.py spread rwkv6_3b`), so no
# longer run can be held against it; its first step from the draw is.
INPOD_FAMILY_CASES = (
    ("olmoe_tp", "olmoe_1b_7b", "1x2x2", "f", {}, 3),
    ("rwkv6_tp", "rwkv6_3b", "1x2x2", "g", {}, 1),
    ("qwen3_qat", "qwen3_8b", "1x2x2", "h",
     {"spe_bits": 8, "spe_sparse": True}, 3),
    ("whisper_dp", "whisper_tiny", "1x2x2", "i", {}, 3),
)


def family_rows() -> list:
    """INPOD_FAMILY_CASES as rows of `_dist_reference.py inpod`'s cases:
    INPOD_CASES' columns (mode f32, the multi-pod step, no warm-up), the
    overrides' repr and the steps."""
    return [(tag, name, "f32", "multipod", spec, proc, "0", repr(over),
             str(steps))
            for tag, name, spec, proc, over, steps in INPOD_FAMILY_CASES]


# the leaf of each family whose block rank 0's launcher state shows
FAMILY_LEAVES = {"olmoe-1b-7b": ("blocks", "pos0", "moe", "w_gate"),
                 "rwkv6-3b": ("blocks", "pos0", "rwkv", "w_r", "w"),
                 "qwen3-8b": ("blocks", "pos0", "ffn", "w_down", "w"),
                 "whisper-tiny": ("embed", "w")}


def _meta(tree):
    return tree_map(lambda x: torch.empty_like(x, device="meta"), tree)


def warm_state(name: str, batches: list) -> dict:
    """The numpy state (params, AdamW's m and v, step) that one process's
    donated steps on `batches` leave from the reduced config's draw (seed
    0) in float32, AdamW 3e-3."""
    cfg = dataclasses.replace(configs.reduced(name), dtype="float32")
    model = api.build_model(cfg, tp=1, max_seq=32)
    opt = optim.adamw(3e-3)
    state = trainer.init_state(model.init(0, device="cpu"), opt,
                               device="cpu")
    step = trainer.make_train_step(model.loss, opt, clip_norm=1.0,
                                   donate=True)
    for b in batches:
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    return tree_map(lambda x: np.array(x.numpy()), {
        "params": state["params"], "opt": state["opt"],
        "step": state["step"]})


def inpod_setup(name: str, params_np: dict, spec: str, mode: str,
                kind: str = "multipod", warm: dict | None = None,
                **overrides):
    """(cfg, model, opt, step, shardings, state of this rank's blocks,
    mesh) for one in-pod case from the global float32 params (and the
    `warm` moments and step, where given; `overrides` replace config
    fields), as `launch.train` builds it; the mesh's ranks only (others
    get None)."""
    from repro_torch.dist import sharding as shd

    cfg = dataclasses.replace(configs.reduced(name), dtype="float32",
                              **overrides)
    model = api.build_model(cfg, tp=1, max_seq=32)
    opt = optim.adamw(3e-3)
    params = convert.lm_params_from_numpy(params_np, device="cpu")
    shapes = {"params": _meta(params), "opt": opt.init(_meta(params)),
              "step": torch.empty((), dtype=torch.int32, device="meta")}
    if kind == "sharded":
        mesh = make_smoke_mesh(*(int(x) for x in spec.split("x")), "cpu")
        if mesh.get_coordinate() is None:
            return None
        batch = {"tokens": torch.zeros((8, 16), dtype=torch.int32),
                 "targets": torch.zeros((8, 16), dtype=torch.int32)}
        step, sh, _ = trainer.make_sharded_train_step(
            model.loss, opt, cfg, mesh, shapes, batch)
        err = None
    else:
        mesh = make_multipod_mesh(spec, "cpu")
        if mesh.get_coordinate() is None:
            return None
        compress = mode != "f32"
        scheme = mode if compress else "gather"
        err = trainer.init_dp_err(params, mesh, scheme=scheme,
                                  compress=compress)
        step, sh = trainer.make_multipod_train_step(
            model.loss, opt, cfg, mesh, {**shapes, "err": err},
            scheme=scheme, compress=compress)
    placed = shd.place(params, tree_map(lambda s: s.spec, sh["params"]), mesh)
    state = trainer.init_state(placed, opt, device="cpu")
    if warm is not None:
        moments = {k: convert.lm_params_from_numpy(v, device="cpu")
                   for k, v in warm["opt"].items()}
        state["opt"] = shd.place(moments, tree_map(lambda s: s.spec,
                                                   sh["opt"]), mesh)
        state["step"] = torch.tensor(int(warm["step"]), dtype=torch.int32)
    if err is not None:
        state["err"] = err
    return cfg, model, opt, step, sh, state, mesh


def _inpod_runs(inputs: dict, out: dict) -> None:
    """Each case of INPOD_CASES: 3 steps on its mesh from the reference's
    params and batches; the metrics, the first step's error buffers and
    the final state, gathered to the global layout."""
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in inputs["batches"]]
    for tag, name, mode, kind, spec, _, warm in INPOD_CASES:
        got = inpod_setup(name, inputs["params"][tag], spec, mode, kind,
                          inputs["warm"].get(tag))
        if got is None:
            continue
        _, _, _, step, sh, state, _ = got
        for i, b in enumerate(batches[warm:warm + STEPS]):
            state, m = step(state, b)
            for k, v in m.items():
                out[f"{tag}/metrics/{k}/{i}"] = float(v)
            if i == 0 and "err" in state:
                for k, v in ckpt._flatten({"err": state["err"]},
                                          {"err": sh["err"]}).items():
                    out[f"{tag}/step0/{k}"] = v
        for k, v in ckpt._flatten(state, sh).items():
            out[f"{tag}/state/{k}"] = v


def _adjoints(out: dict) -> None:
    """Each collective's gradient on a 2x2 ("data", "model") mesh, in
    float64, against the adjoint worked out by hand (the table in
    `dist.sharding`): the largest difference from it, per collective."""
    from repro_torch.dist import sharding as shd

    mesh = make_smoke_mesh(2, 2, "cpu")
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    cfg = configs.reduced("qwen3_8b")
    gen = torch.Generator().manual_seed(11)
    # every rank draws the same numbers and picks its own by coordinate
    w = torch.randn((2, 2, 4, 6), generator=gen, dtype=torch.float64)
    x = torch.randn((2, 2, 4, 6), generator=gen, dtype=torch.float64)

    def grad(fn, x0, specs=None):
        x0 = x0.clone().requires_grad_(True)
        with shd.activation_context(cfg, mesh, specs=specs):
            (g,) = torch.autograd.grad(fn(x0), x0)
        return g

    def gap(a, b) -> float:
        return float((a - b).abs().max())

    err = {}
    # reduce_model: partials -> their sum; each partial's gradient is the
    # replicated upstream gradient
    g = grad(lambda t: (shd.reduce_model(t) * w[d, 0]).sum(), x[d, m])
    err["reduce_model"] = gap(g, w[d, 0])
    # gather_model: this rank's block of the replicated upstream gradient
    up = w[d, 0].repeat(1, 2)  # (4, 12), the same on both model ranks
    g = grad(lambda t: (shd.gather_model(t, -1) * up).sum(), x[d, m])
    err["gather_model"] = gap(g, up[:, 6 * m:6 * m + 6])
    # model_block: every rank's block gradient, all-gathered whole
    g = grad(lambda t: (shd.model_block(t, -1) * w[d, m, :, :3]).sum(),
             x[d, 0])
    err["model_block"] = gap(g, torch.cat([w[d, r, :, :3] for r in (0, 1)],
                                          dim=-1))
    # enter_model: the ranks' partial gradients summed over model
    g = grad(lambda t: (shd.enter_model(t) * w[d, m]).sum(), x[d, 0])
    err["enter_model"] = gap(g, w[d, 0] + w[d, 1])
    # gather_block: an FSDP leaf's gradient summed over data into this
    # rank's block (a leaf split on its rows, one on its columns)
    specs = {"a": {"w": ("data", None)}, "b": {"w": (None, "data")}}
    wa = [w[r].reshape(8, 6) for r in (0, 1)]  # data rank r's upstream
    wb = [w[r].reshape(4, 12) for r in (0, 1)]

    def gb(t):
        got = shd.gather_block({"a": {"w": t}, "b": {"w": 2 * t}}, specs)
        return (got["a"]["w"] * wa[d]).sum() + (got["b"]["w"] * wb[d]).sum()

    g = grad(gb, x[d, m], specs)
    want = (wa[0] + wa[1])[4 * d:4 * d + 4] + \
        2 * (wb[0] + wb[1])[:, 6 * d:6 * d + 6]
    err["gather_block"] = gap(g, want)
    out["adjoint_err"] = err


def _keyed(tree) -> dict:
    """'/'-joined path -> leaf (None leaves skipped), `ckpt._flatten`'s
    keys."""
    from repro_torch._tree import map_with_path

    got: dict = {}
    map_with_path(lambda path, x: got.__setitem__("/".join(path), x)
                  if x is not None else None, tree)
    return got


def _replicated_grads_and_whole(inputs: dict, out: dict) -> None:
    """On 1x2x2: stage A's gradients (trainer._block_grads) — every leaf
    that no axis splits equal on all 4 ranks bit for bit, and the blocks
    gathered whole against one process's gradient on the whole batch;
    the collectives of the step's forward and backward, by kind. Also
    qwen3 with its CE chunked over S (4 positions a chunk)."""
    from repro_torch.dist import sharding as shd

    for tag, src, extra in (("qwen3_f32", "qwen3_f32", {}),
                            ("rg_f32", "rg_f32", {}),
                            ("qwen3_chunked", "qwen3_f32",
                             {"loss_chunk": 4})):
        name = dict((t, n) for t, n, *_ in INPOD_CASES)[src]
        cfg, model, _, _, sh, state, mesh = inpod_setup(
            name, inputs["params"][src], "1x2x2", "f32", "multipod",
            inputs["warm"].get(src), **extra)
        specs = tree_map(lambda s: s.spec, sh["params"])
        batch = {k: torch.from_numpy(v) for k, v in
                 inputs["batches"][0].items()}
        shd.reset_comm()
        grads, _ = trainer._block_grads(
            trainer._grad_fn(model.loss), state["params"],
            trainer._rows(batch, cfg, mesh), cfg, mesh, specs, 1)
        out[f"{tag}/comm"] = dict(shd.comm_calls)
        same = True
        for g, spec in zip(leaves(grads), leaves(specs)):
            if shd.spec_shard_factor(spec, mesh) == 1:
                ref = g.clone()
                dist.broadcast(ref, src=0)
                same &= bool(torch.equal(ref, g))
        out[f"{tag}/replicated_equal"] = _all_ranks_true(same)
        whole = shd.unplace(grads, specs, mesh)
        params = convert.lm_params_from_numpy(inputs["params"][src], "cpu")
        one, _ = trainer._grad_fn(model.loss)(params, batch)
        out[f"{tag}/whole_vs_one"] = max(
            float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(leaves(whole), leaves(one)))


def _kill_resume_inpod(inputs: dict, tmp: str, out: dict) -> None:
    """1x2x2 (two_stage) under fault.run_training with restore_shardings:
    killed after 5 steps and resumed against the uninterrupted 8; then
    its checkpoint restored on 1x4x1 and (rank 0) unsharded, each equal
    bit for bit to the saved global arrays."""
    from repro_torch.data import lm
    from repro_torch.dist import sharding as shd

    params_np = inputs["params"]["qwen3_f32"]
    cfg, model, opt, step, sh, state0, mesh = inpod_setup(
        "qwen3_8b", params_np, "1x2x2", "two_stage")
    stream = lm.TokenStream(batch=8, seq_len=16, vocab=cfg.vocab, seed=0,
                            device="cpu")
    fresh = lambda: tree_map(torch.clone, state0)  # noqa: E731
    d1, d2 = (os.path.join(tmp, x) for x in ("inpod_a", "inpod_b"))
    kw = dict(ckpt_every=3, log_every=0, restore_shardings=sh)
    final1, hist1 = fault.run_training(
        step, fresh(), stream.batch_at, num_steps=8, ckpt_dir=d1, **kw)
    fault.run_training(
        step, fresh(), stream.batch_at, num_steps=5, ckpt_dir=d2, **kw)
    final2, hist2 = fault.run_training(
        step, fresh(), stream.batch_at, num_steps=8, ckpt_dir=d2, **kw)
    ok = (hist2[0]["step"] == 5
          and [h["loss"] for h in hist1 if h["step"] >= 5]
          == [h["loss"] for h in hist2]
          and _runs_equal(final1, final2))
    out["inpod_kill_resume_bitwise"] = _all_ranks_true(ok)
    out["inpod_kill_resume_losses"] = [h["loss"] for h in hist1]
    out["inpod_ckpt_dir"] = d1

    saved = dict(np.load(os.path.join(d1, "step_00000008", "arrays.npz")))
    got = inpod_setup("qwen3_8b", params_np, "1x4x1", "two_stage")
    _, _, _, _, sh4, like4, mesh4 = got
    back, s = ckpt.restore(d1, like4, shardings=sh4)
    specs4 = tree_map(lambda x: x.spec, sh4)
    # each rank's block is the saved array's block under the 1x4x1 specs
    blocks = ckpt._flatten(back)
    same = s == 8 and sorted(blocks) == sorted(saved) and all(
        np.array_equal(blocks[k], np.asarray(shd.shard_local(
            saved[k], spec, mesh4)))
        for k, spec in _keyed(specs4).items())
    gathered = ckpt._flatten(back, sh4)
    same &= all(np.array_equal(gathered[k], saved[k]) for k in saved)
    out["inpod_elastic_1x4x1"] = _all_ranks_true(bool(same))
    if _spawn.rank() == 0:
        whole = {"params": convert.lm_params_from_numpy(params_np, "cpu")}
        whole["opt"] = opt.init(whole["params"])
        whole["step"] = torch.zeros((), dtype=torch.int32)
        whole["err"] = tree_map(torch.zeros_like, state0["err"])
        back, s = ckpt.restore(d1, whole)
        flat = ckpt._flatten(back)
        out["inpod_elastic_unsharded"] = s == 8 and sorted(flat) == sorted(
            saved) and all(np.array_equal(flat[k], saved[k]) for k in saved)


def _entry_inpod(out: dict) -> None:
    """launch.train --multi-pod 1x2x2 / 2x2x1 / 2x1x2 through `main` in
    this group: each rank's final state holds its blocks."""
    from repro_torch.launch import train as launch_train

    base = ["--arch", "qwen3-8b", "--reduced", "--steps", "2", "--batch",
            "8", "--seq", "16", "--log-every", "0"]
    for spec, extra in (("1x2x2", ["--no-compress"]),
                        ("2x2x1", ["--scheme", "gather"]),
                        ("2x1x2", ["--scheme", "two_stage"])):
        rec = launch_train.main([*base, "--multi-pod", spec, *extra],
                                device="cpu")
        if rec is not None:
            st = rec["state"]
            out[f"launch_{spec}"] = {
                "losses": [h["loss"] for h in rec["history"]],
                "grad_norms": [h["grad_norm"] for h in rec["history"]],
                "step": int(st["step"]),
                "err_keys": sorted(st["err"]),
                "wq": tuple(st["params"]["blocks"]["pos0"]["mix"]["wq"][
                    "w"].shape),
                "m_wq": tuple(st["opt"]["m"]["blocks"]["pos0"]["mix"]["wq"][
                    "w"].shape),
                "err_wq": tuple(st["err"]["s1"]["blocks"]["pos0"]["mix"][
                    "wq"]["w"].shape) if st["err"] else None}


def _family_runs(inputs: dict, out: dict) -> None:
    """Each case of INPOD_FAMILY_CASES: its steps on its mesh from the
    reference's params and the case's own batches; the metrics and the
    final state, gathered to the global layout."""
    for tag, name, spec, _, over, steps in INPOD_FAMILY_CASES:
        got = inpod_setup(name, inputs["params"][tag], spec, "f32",
                          **over)
        if got is None:
            continue
        _, _, _, step, sh, state, _ = got
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in inputs["batches"][tag]]
        for i, b in enumerate(batches[:steps]):
            state, m = step(state, b)
            for k, v in m.items():
                out[f"{tag}/metrics/{k}/{i}"] = float(v)
        for k, v in ckpt._flatten(state, sh).items():
            out[f"{tag}/state/{k}"] = v


def _qat_at_model_one(inputs: dict, out: dict) -> None:
    """On 1x1x1 (rank 0's mesh), the QAT case's multi-pod step against
    `make_train_step` in one process, 2 steps from the same state: where
    `model` is 1 no scale is reduced, so the two equal bit for bit."""
    tag = "qwen3_qat"
    case = dict((c[0], c) for c in INPOD_FAMILY_CASES)[tag]
    got = inpod_setup(case[1], inputs["params"][tag], "1x1x1", "f32",
                      **case[4])
    if got is None:
        return
    _, model, opt, step, _, state, _ = got
    one = trainer.make_train_step(model.loss, opt, clip_norm=1.0,
                                  donate=True)
    core = ("params", "opt", "step")
    twin = {k: tree_map(torch.clone, state[k]) for k in core}
    same = True
    for b in inputs["batches"][tag][:2]:
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        state, m1 = step(state, b)
        twin, m2 = one(twin, b)
        same &= all(torch.equal(m1[k], m2[k]) for k in ("loss", "grad_norm"))
    out["qat_1x1x1_bitwise"] = same and all(
        torch.equal(a, b) for a, b in zip(
            leaves({k: state[k] for k in core}), leaves(twin)))


def _entry_families(out: dict) -> None:
    """launch.train --multi-pod 1x2x2 through `main` for each family in
    this group: rank 0's record, the shape of one leaf that the model
    axis splits (or, for whisper, keeps whole)."""
    from repro_torch.launch import train as launch_train

    for arch, extra in (("olmoe-1b-7b", []), ("rwkv6-3b", []),
                        ("qwen3-8b", ["--spe-bits", "8", "--spe-sparse"]),
                        ("whisper-tiny", [])):
        rec = launch_train.main(
            ["--arch", arch, "--reduced", "--multi-pod", "1x2x2",
             "--steps", "2", "--batch", "8", "--seq", "16",
             "--log-every", "0", *extra], device="cpu")
        if rec is not None:
            x = rec["state"]["params"]
            for k in FAMILY_LEAVES[arch]:
                x = x[k]
            out[f"launch_{arch}"] = {
                "losses": [h["loss"] for h in rec["history"]],
                "grad_norms": [h["grad_norm"] for h in rec["history"]],
                "step": int(rec["state"]["step"]), "leaf": tuple(x.shape)}


def inpod_families(inputs: dict, tmp: str) -> dict | None:
    """MoE, RWKV-6, the QAT and whisper over the in-pod axes on 4 ranks:
    the cases held against the reference, the QAT step at 1x1x1 against
    one process's, and the launcher."""
    out: dict = {}
    _family_runs(inputs, out)
    _qat_at_model_one(inputs, out)
    _entry_families(out)
    return out if _spawn.rank() == 0 else None


def inpod(inputs: dict, tmp: str) -> dict | None:
    """The in-pod training on 4 ranks: the cases held against the
    reference, the adjoints, the replicated gradients, the step's
    collectives, kill-and-resume, the elastic restores and the
    launcher."""
    out: dict = {}
    _inpod_runs(inputs, out)
    _adjoints(out)
    _replicated_grads_and_whole(inputs, out)
    _kill_resume_inpod(inputs, tmp, out)
    _entry_inpod(out)
    return out if _spawn.rank() == 0 else None


# ---------------------------------------------------------------------------
# the serve sweeps over a mesh (launch.serve --load-sweep / --frontend-sweep)
# ---------------------------------------------------------------------------

SWEEP_FLAGS = (("--load-sweep",), ("--frontend-sweep", "--patients", "4"))


def capture_requests(build):
    """`build` (`launch.serve._build_lm_engine`) whose engines keep every
    request handed to them, and the list they keep them in."""
    seen: list = []

    def wrapped(args, device=None):
        cfg, make_engine, make_prompts = build(args, device)

        def make():
            eng = make_engine()
            if not getattr(eng, "_captured", False):
                submit = eng.submit

                def keep(req):
                    submit(req)
                    seen.append(req)

                eng.submit = keep
                eng._captured = True
            return eng

        return cfg, make, make_prompts

    return wrapped, seen


def request_tokens(seen: list) -> dict:
    """(uid, prompt) -> tokens of every finished request (a sweep's points
    reuse uids and prompts: each pair must always give the same)."""
    out: dict = {}
    for r in seen:
        assert r.done, r.uid
        key = (r.uid, tuple(int(v) for v in r.prompt))
        toks = [int(v) for v in r.output]
        assert out.setdefault(key, toks) == toks, key
    return out


def serve_sweeps(argv: list, meshes: list) -> dict | None:
    """Both sweeps of `launch.serve` over each mesh in `meshes`, on every
    rank: rank 0 returns each run's record and its requests' tokens."""
    from unittest import mock

    from repro_torch.launch import serve as tlaunch

    out: dict = {}
    for spec in meshes:
        for flags in SWEEP_FLAGS:
            wrapped, seen = capture_requests(tlaunch._build_lm_engine)
            with mock.patch.object(tlaunch, "_build_lm_engine", wrapped):
                rec = tlaunch.main(list(argv) + list(flags)
                                   + ["--mesh", spec], device="cpu")
            out[(spec, flags[0])] = {"record": rec,
                                     "tokens": request_tokens(seen)}
    return out if _spawn.rank() == 0 else None

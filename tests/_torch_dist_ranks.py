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
from repro_torch.launch.mesh import make_data_mesh, make_multipod_mesh
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

"""The JAX package's side of the multi-rank tests: run in a subprocess
with 4 forced host devices, read numpy inputs, write numpy outputs.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_dist_reference.py compression IN.npz OUT.npz
    ... python tests/_dist_reference.py multipod MODE N IN.npz OUT.npz CKPT

`compression`: for n in (2, 4), the leaves l0, l1 of IN (each (4, ...)
per-pod gradients, first n rows used) through `compressed_psum_mean`,
`two_stage_psum_mean` (two calls, the errors fed back) and
`uncompressed_psum_mean` (also without the finite guard) inside
`shard_map` over a ("pod",) mesh.

`multipod`: 3 steps of `trainer.make_multipod_train_step` on 2x1 and
4x1 meshes for one MODE (gather, two_stage, or f32: uncompressed) from
the reduced qwen3-8b's `init(PRNGKey(0))` in float32 and
`TokenStream(batch=8, seq_len=16, seed=0)`'s batches, AdamW 3e-3; the
final params, moments, error buffers and per-step metrics; the 4-pod
state also checkpointed to CKPT_DIR. One process a mode, so that the
three compile at once.

    ... python tests/_dist_reference.py decode DxM IN.npz OUT.npz TAGS

`decode`: `serve.sharded`'s plan, placement and compiled prefill and
decode step on a DxM `make_smoke_mesh`, greedy, for each case of IN
(`cases`: tag, config name, the format: 0 float32, the packed bits, or
"spe8"; `<tag>/params/<path>` the float32 or packed params, or the SPE
tree's values, selects, scales and meta, which run here as the dense
weights they decompress to; `prompts`, `new`) whose tag TAGS lists
(comma-separated): the prefill's and every decode step's logits and the
tokens; also `sharded_generate`'s tokens. A few cases a process, so that
they compile at once.

    ... python tests/_dist_reference.py inpod PROC IN.npz OUT.npz

`inpod`: 3 steps of `trainer.make_multipod_train_step` on a PxDxM mesh
with D·M > 1 (the parameters placed over `data` and `model` by
`param_specs`, the moments mirroring them) for each case of IN of the
process (`cases`: tag, config name, mode — gather, two_stage or f32 —,
"multipod" or "sharded", the mesh, the process that runs it: PROC, and
W, the warm-up steps); "sharded" runs `make_sharded_train_step` on a 2x2
("data", "model") smoke mesh; `<tag>/params/<path>` the float32 params
(and where W > 0 `<tag>/opt/{m,v}/<path>` and `<tag>/step`, the state W
steps left on one process), `batch/<i>/<key>` the batches, of which a
case takes W to W + 2; each step's metrics, the first step's error
buffers and the final state gathered. A few cases a process, so that they compile
at once. A case may carry two more columns, the config fields it
overrides (a dict's repr) and the steps it runs (3 where
absent), and its own batches, `<tag>/batch/<i>/<key>` (whisper's carry
frames).

    ... python tests/_dist_reference.py spread [CONFIG]

`spread`: the reference against itself, the measurement behind the
in-pod test's warm start for recurrentgemma (CONFIG, the default
recurrentgemma_2b) and behind the families file's one step for rwkv6
(rwkv6_3b). The reduced CONFIG in float32 from its own draw
(`init(PRNGKey(0))`) and its own
`TokenStream(batch=8, seq_len=16, seed=0)`, AdamW 3e-3:
`make_multipod_train_step` on 1x1x1 and on 1x2x2, 3 steps each, from the
draw (batches 0-2) and from the state 3 single-device steps leave
(batches 3-5). Prints, for each start, each layout's grad norm at each
step and the largest difference between the two layouts' params, m and
v after the 3 steps, over each tree's max.

    ... python tests/_dist_reference.py dryrun OUT.json

`dryrun`: the reference dry-run's accounting as JSON: `count_params` and
`model_flops` of every `CLI_IDS` arch and applicable shape (from
`jax.eval_shape`), and `lower_cell` + `analyze` of the reduced qwen3-8b's
decode, prefill and train cells (batch 8, sequence 64) on a 2x2
("data", "model") mesh of the 4 forced host devices: the record's
argument bytes, MODEL_FLOPS, device count and mesh, and each input
leaf's bytes a device under the compiled step's input shardings (by
path: "params/...", "opt/..." for the train state). `jax.devices()`
runs before `repro.launch.dryrun` is imported, which sets a 512-device
XLA_FLAGS for its own runs.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=4 "
    + os.environ.get("XLA_FLAGS", "")
).strip()
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import ast  # noqa: E402
import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

STEPS = 3
SPE = "spe8"  # decode's format of an SPE serving tree: 16:8, 8 bits


def _pod_mesh(n):
    return jax.make_mesh(
        (n,), ("pod",), devices=jax.devices()[:n],
        axis_types=(jax.sharding.AxisType.Auto,),
    )


def _flat(prefix: str, tree, out: dict) -> None:
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in kp)
        out[f"{prefix}/{key}"] = np.asarray(leaf)


def compression(inp: str, outp: str) -> None:
    from repro.dist import compression as C

    data = dict(np.load(inp))
    names = sorted(k for k in data if k.startswith("l"))
    out = {}
    sq = lambda t: jax.tree.map(lambda x: x[0], t)  # noqa: E731
    ex = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731
    for n in (2, 4):
        mesh = _pod_mesh(n)
        g = {k: jnp.asarray(data[k][:n]) for k in names}

        def gather(gg, ee):
            m, ne = C.compressed_psum_mean(sq(gg), sq(ee), "pod")
            return m, ex(ne)

        def two(gg, e1, e2):
            m, a, b = C.two_stage_psum_mean(sq(gg), sq(e1), sq(e2), "pod")
            return m, ex(a), ex(b)

        f_gather = jax.jit(shard_map(
            gather, mesh=mesh, in_specs=(P("pod"), P("pod")),
            out_specs=(P(), P("pod")), check_rep=False))
        f_two = jax.jit(shard_map(
            two, mesh=mesh, in_specs=(P("pod"),) * 3,
            out_specs=(P(), P("pod"), P("pod")), check_rep=False))
        e = {k: jnp.zeros_like(v) for k, v in g.items()}
        e1 = dict(e)
        e2 = {k: jnp.zeros((n, C.two_stage_shard_len(v[0].size, n)))
              for k, v in g.items()}
        for step in range(2):
            m, e = f_gather(g, e)
            _flat(f"n{n}/gather/mean{step}", m, out)
            _flat(f"n{n}/gather/err{step}", e, out)
            m, e1, e2 = f_two(g, e1, e2)
            _flat(f"n{n}/two_stage/mean{step}", m, out)
            _flat(f"n{n}/two_stage/err1_{step}", e1, out)
            _flat(f"n{n}/two_stage/err2_{step}", e2, out)
        for guard in (True, False):
            f_unc = jax.jit(shard_map(
                lambda gg, guard=guard: C.uncompressed_psum_mean(
                    sq(gg), "pod", finite_guard=guard),
                mesh=mesh, in_specs=(P("pod"),), out_specs=P(),
                check_rep=False))
            _flat(f"n{n}/uncompressed{'' if guard else '_raw'}/mean0",
                  f_unc(g), out)
    np.savez(outp, **out)


def multipod(mode: str, n: int, inp: str, outp: str, ckpt_dir: str) -> None:
    from repro import configs, optim
    from repro.launch.mesh import make_multipod_mesh
    from repro.models import api
    from repro.train import checkpoint as ckpt
    from repro.train import trainer

    cfg = dataclasses.replace(configs.reduced("qwen3_8b"), dtype="float32")
    model = api.build_model(cfg, tp=1, max_seq=32)
    data = dict(np.load(inp))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(data["params/" + "/".join(str(k.key) for k in kp)])
        for kp, _ in paths])
    compress = mode != "f32"
    scheme = mode if compress else "gather"
    out = {}
    mesh = make_multipod_mesh(f"{n}x1")
    opt = optim.adamw(3e-3)
    state = trainer.init_state(params, opt)
    state["err"] = trainer.init_dp_err(
        params, mesh, scheme=scheme, compress=compress)
    step, shardings = trainer.make_multipod_train_step(
        model.loss, opt, cfg, mesh, jax.eval_shape(lambda: state),
        scheme=scheme, compress=compress,
    )
    # seated as the step leaves it (as a restore places it), so the second
    # step does not compile again
    state = jax.device_put(state, shardings)
    for i in range(STEPS):
        batch = {k.split("/")[-1]: jnp.asarray(v) for k, v in data.items()
                 if k.startswith(f"batch/{i}/")}
        state, m = step(state, batch)
        for k, v in m.items():
            out[f"n{n}/metrics/{k}/{i}"] = np.asarray(v)
        if i == 0:
            _flat(f"n{n}/step0/err", state["err"], out)
    _flat(f"n{n}/state", state, out)
    ckpt.save(state, ckpt_dir, STEPS)
    np.savez(outp, **out)


def _spe_dense(data: dict, prefix: str) -> jax.Array:
    """One SPE serving linear of IN (`<prefix>values_q`, `select`, `scale`
    and `meta/{group,keep}`; a stacked (G, Kk, N) group one slice at a
    time) as the dense weight of the same function, decompressed by this
    package's `decompress_tile` and scaled per column."""
    from repro.kernels._common import decompress_tile

    group = int(data[prefix + "meta/group"])
    keep = int(data[prefix + "meta/keep"])
    vq, sel, scale = (jnp.asarray(data[prefix + k])
                      for k in ("values_q", "select", "scale"))

    def one(v, s, c):
        return decompress_tile(v, s, group, keep) * c

    if vq.ndim == 3:
        return jnp.stack([one(*x) for x in zip(vq, sel, scale)])
    return one(vq, sel, scale)


def decode(spec: str, inp: str, outp: str, tags: str) -> None:
    from repro import configs
    from repro.launch.mesh import make_smoke_mesh
    from repro.models import api
    from repro.serve import engine as E
    from repro.serve import sharded as SH

    data = dict(np.load(inp))
    prompts = jnp.asarray(data["prompts"], jnp.int32)
    b, s = prompts.shape
    new = int(data["new"])
    n_data, n_model = (int(x) for x in spec.split("x"))
    mesh = make_smoke_mesh(n_data, n_model)
    out = {}
    for case in data["cases"]:
        tag, name, fmt = str(case[0]), str(case[1]), str(case[2])
        if tag not in tags.split(","):
            continue
        bits = 0 if fmt == SPE else int(fmt)
        cfg = dataclasses.replace(configs.reduced(name), dtype="float32")
        model = api.build_model(cfg, tp=1, max_seq=int(data["max_seq"]))

        def init(model=model, bits=bits):
            p = model.init(jax.random.PRNGKey(0))
            return E.quantize_for_serving(p, bits) if bits else p

        def leaf(key):
            if key in data or fmt != SPE:
                return jnp.asarray(data[key])
            return _spe_dense(data, key[:-len("w")])

        paths, treedef = jax.tree_util.tree_flatten_with_path(
            jax.eval_shape(init))
        params = jax.tree_util.tree_unflatten(treedef, [
            leaf(f"{tag}/params/" + "/".join(str(k.key) for k in kp))
            for kp, _ in paths])
        plan = SH.plan_decode(model, params, mesh, batch_size=b)
        prefill, step = SH.compile_decode(model, plan)
        placed = SH.place_params(params, plan)
        logits, cache = prefill(placed, jax.device_put(prompts, plan.prompts))
        out[f"{tag}/logits/0"] = np.asarray(logits)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks = []
        for t in range(new):
            toks.append(tok)
            pos = jax.device_put(jnp.full((b,), s + t, jnp.int32), plan.token)
            logits, cache = step(placed, cache,
                                 jax.device_put(tok, plan.token), pos)
            out[f"{tag}/logits/{t + 1}"] = np.asarray(logits)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out[f"{tag}/tokens"] = np.stack([np.asarray(x) for x in toks], 1)
        out[f"{tag}/generate"] = np.asarray(SH.sharded_generate(
            model, placed, prompts, mesh=mesh, max_new=new,
            params_placed=True, plan=plan))
    np.savez(outp, **out)


def _params_from(data: dict, prefix: str, shapes):
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(data[prefix + "/".join(str(k.key) for k in kp)])
        for kp, _ in paths])


def inpod(proc: str, inp: str, outp: str) -> None:
    from repro import configs, optim
    from repro.launch.mesh import make_multipod_mesh, make_smoke_mesh
    from repro.models import api
    from repro.train import trainer

    data = dict(np.load(inp))
    out = {}
    for case in data["cases"]:
        tag, name, mode, kind, spec, where, warm, *over = (
            str(x) for x in case)
        if where != proc:
            continue
        fields, n_steps = ((ast.literal_eval(over[0]), int(over[1]))
                           if over else ({}, STEPS))
        cfg = dataclasses.replace(configs.reduced(name), dtype="float32",
                                  **fields)
        model = api.build_model(cfg, tp=1, max_seq=32)
        shapes = jax.eval_shape(
            lambda model=model: model.init(jax.random.PRNGKey(0)))
        params = _params_from(data, f"{tag}/params/", shapes)
        own = any(k.startswith(f"{tag}/batch/") for k in data)
        pre = f"{tag}/batch/" if own else "batch/"
        batches = [{k.split("/")[-1]: jnp.asarray(v) for k, v in data.items()
                    if k.startswith(f"{pre}{i}/")}
                   for i in range(int(warm), int(warm) + n_steps)]
        opt = optim.adamw(3e-3)
        state = trainer.init_state(params, opt)
        if int(warm):  # the warm state's moments and step
            state["opt"] = {k: _params_from(data, f"{tag}/opt/{k}/", shapes)
                            for k in ("m", "v")}
            state["step"] = jnp.asarray(data[f"{tag}/step"], jnp.int32)
        if kind == "sharded":
            mesh = make_smoke_mesh(2, 2)
            step, s_shard, b_shard = trainer.make_sharded_train_step(
                model.loss, opt, cfg, mesh, jax.eval_shape(lambda: state),
                jax.eval_shape(lambda: batches[0]), clip_norm=1.0)
            state = jax.device_put(state, s_shard)
            batches = [jax.device_put(b, b_shard) for b in batches]
        else:
            compress = mode != "f32"
            scheme = mode if compress else "gather"
            mesh = make_multipod_mesh(spec)
            state["err"] = trainer.init_dp_err(
                params, mesh, scheme=scheme, compress=compress)
            step, s_shard = trainer.make_multipod_train_step(
                model.loss, opt, cfg, mesh, jax.eval_shape(lambda: state),
                scheme=scheme, compress=compress)
            state = jax.device_put(state, s_shard)
        for i, batch in enumerate(batches):
            state, m = step(state, batch)
            for k, v in m.items():
                out[f"{tag}/metrics/{k}/{i}"] = np.asarray(v)
            if i == 0 and "err" in state:
                _flat(f"{tag}/step0/err", state["err"], out)
        _flat(f"{tag}/state", state, out)
    np.savez(outp, **out)


def spread(name: str = "recurrentgemma_2b") -> None:
    import json

    from repro import configs, optim
    from repro.data import lm
    from repro.launch.mesh import make_multipod_mesh
    from repro.models import api
    from repro.train import trainer

    cfg = dataclasses.replace(configs.reduced(name), dtype="float32")
    model = api.build_model(cfg, tp=1, max_seq=32)
    opt = optim.adamw(3e-3)
    stream = lm.TokenStream(batch=8, seq_len=16, vocab=cfg.vocab, seed=0)
    cold = trainer.init_state(model.init(jax.random.PRNGKey(0)), opt)
    warm = jax.tree.map(jnp.copy, cold)
    one = jax.jit(trainer.make_train_step(model.loss, opt))
    for i in range(STEPS):
        warm, _ = one(warm, stream.batch_at(i))
    for start_name, start, first in (("draw", cold, 0),
                                     ("warm", warm, STEPS)):
        finals, norms = {}, {}
        for spec in ("1x1x1", "1x2x2"):
            mesh = make_multipod_mesh(spec)
            state = jax.tree.map(jnp.copy, start)
            state["err"] = trainer.init_dp_err(state["params"], mesh,
                                               compress=False)
            step, sh = trainer.make_multipod_train_step(
                model.loss, opt, cfg, mesh, jax.eval_shape(lambda: state),
                compress=False)
            state = jax.device_put(state, sh)
            norms[spec] = []
            for i in range(first, first + STEPS):
                state, m = step(state, stream.batch_at(i))
                norms[spec].append(float(m["grad_norm"]))
            finals[spec] = state
        rec = {"config": cfg.name, "start": start_name, "grad_norm": norms}
        for part, get in (("params", lambda s: s["params"]),
                          ("m", lambda s: s["opt"]["m"]),
                          ("v", lambda s: s["opt"]["v"])):
            a = [np.asarray(x) for x in jax.tree.leaves(get(finals["1x1x1"]))]
            b = [np.asarray(x) for x in jax.tree.leaves(get(finals["1x2x2"]))]
            top = max(float(np.abs(y).max()) for y in b)
            rec[part] = max(float(np.abs(x - y).max())
                            for x, y in zip(a, b)) / top
        print(json.dumps(rec))


def dryrun(outp: str) -> None:
    import json

    jax.devices()  # 4 host devices, before dryrun's import sets 512
    from repro import configs
    from repro.configs.base import applicable_shapes
    from repro.launch import dryrun as D

    out: dict = {"params": {}, "model_flops": {}, "cells": {}}
    for arch in configs.CLI_IDS:
        cfg = configs.get(arch)
        out["params"][arch] = list(D.count_params(cfg))
        out["model_flops"][arch] = {c.name: D.model_flops(cfg, c)
                                    for c in applicable_shapes(cfg)}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         devices=jax.devices()[:4],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg = configs.reduced("qwen3-8b")
    for shape in ("decode_32k", "prefill_32k", "train_4k"):
        cell = dataclasses.replace(configs.SHAPES[shape], global_batch=8,
                                   seq_len=64)
        compiled, lowered = D.lower_cell(cfg, cell, mesh)
        rec = D.analyze(compiled, cfg, cell, mesh)
        leaf_bytes = {}
        args = lowered.args_info[0]
        names = ("params", "cache", "token", "pos") if shape == "decode_32k" \
            else ("params", "tokens") if shape == "prefill_32k" \
            else ("state", "batch")
        for name, arg, sh in zip(names, args, compiled.input_shardings[0]):
            flat = jax.tree_util.tree_flatten_with_path(arg)[0]
            shards = jax.tree_util.tree_leaves(sh)
            for (kp, leaf), one in zip(flat, shards):
                key = "/".join([name] + [
                    str(getattr(k, "key", getattr(k, "idx", k))) for k in kp])
                local = one.shard_shape(leaf.shape)
                leaf_bytes[key] = int(np.prod(local, dtype=np.int64)
                                      * np.dtype(leaf.dtype).itemsize)
        out["cells"][shape] = {
            "argument_bytes": rec["memory"]["argument_bytes"],
            "model_flops_total": rec["roofline"]["model_flops_total"],
            "n_devices": rec["n_devices"], "mesh": rec["mesh"],
            "leaf_bytes": leaf_bytes,
        }
    with open(outp, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    if sys.argv[1] == "compression":
        compression(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "decode":
        decode(*sys.argv[2:6])
    elif sys.argv[1] == "inpod":
        inpod(sys.argv[2], sys.argv[3], sys.argv[4])
    elif sys.argv[1] == "spread":
        spread(*sys.argv[2:3])
    elif sys.argv[1] == "dryrun":
        dryrun(sys.argv[2])
    else:
        multipod(sys.argv[2], int(sys.argv[3]), *sys.argv[4:7])

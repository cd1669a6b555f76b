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
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=4 "
    + os.environ.get("XLA_FLAGS", "")
).strip()
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

STEPS = 3


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


if __name__ == "__main__":
    if sys.argv[1] == "compression":
        compression(sys.argv[2], sys.argv[3])
    else:
        multipod(sys.argv[2], int(sys.argv[3]), *sys.argv[4:7])

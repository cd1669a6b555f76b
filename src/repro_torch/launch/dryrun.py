"""Multi-pod dry-run: count every (arch x shape x mesh) cell's step on
fake tensors and fake ranks (port of `repro.launch.dryrun`).

For each cell this driver builds the *production* step (the same train
step / prefill / decode step the trainer and server run, on this rank's
blocks of the placed params, cache or state), runs it once on fake
tensors (`torch._subclasses.fake_tensor.FakeTensorMode`: shapes and
dtypes, no storage) as rank 0 of a `"fake"` process group the mesh's
size (`torch.testing._internal.distributed.fake_pg`: every collective
returns at once, nothing moves), and records:

  * memory per device  — the placed arguments (`dist.sharding.
                         bytes_per_device` of params, cache or optimizer
                         state, plus the step's inputs), outputs, donated
                         (aliased) bytes and the peak of live storages
                         over the step (`op_count`);
  * cost               — the step's FLOPs and bytes as the port runs it,
                         the hand-written kernels' launches included
                         (`op_count.count_step`);
  * collective stats   — the bytes and calls handed to `torch.distributed`
                         (`op_analysis`);
  * MODEL_FLOPS        — 6*N*D (train) / 2*N*D (inference), N_active for
                         MoE.

The reference lowers and compiles against `ShapeDtypeStruct`s on 512
forced host devices and reads XLA's analyses; the port runs the eager
step, so its counts are what the port's program does on each rank (no
fusion; every loop trip). The records keep the reference's keys, so
`roofline.py` reads either; they land in
`experiments/dryrun_torch/<mesh>/<arch>__<shape><tag>.json` (no HLO is
kept: `--reanalyze` recomputes the roofline from each record's counts).

Memory keys as the reference's: `argument_bytes`, `output_bytes`,
`alias_bytes` (the donated cache or state, which the port updates in
place), `temp_bytes` (the step's peak of live storages less its
arguments and its new outputs), `total_per_device_bytes` (= arguments +
outputs + temps - aliased: the step's peak) and `bf16_emulation_bytes`
(0: the card computes bf16 natively).

Placement: decode and prefill place params, cache and inputs under the
reference's rules (`param_specs`, `cache_specs`, `batch_specs`, not
strict: a batch the data axes do not divide is replicated, as the
reference's long_500k cell is) and run inside
`dist.sharding.activation_context`. A train cell runs
`trainer.make_sharded_train_step` on a ("data", "model") mesh; on the
multi-pod mesh, the port's step for a pod axis,
`trainer.make_multipod_train_step` uncompressed (the reference's GSPMD
step reduces over the pods itself); both with `replicate_indivisible`,
so a batch the row ranks do not divide runs whole on every rank, as the
reference's unsharded batch does (whisper-tiny's `train_4k` on
2x16x16), where the trainer itself refuses it.

Fake tensors live on `--device`: the card by default (a host with the
card; the count is the same on any), `cpu` where asked (the tests). The
fake group is process-wide: `fake_world` brings it up once, at the
largest mesh the run needs, and `close_fake_world` takes it down.

A cell that fails is reported and the run exits 1, as the reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import _device, configs
from repro_torch._tree import leaves, tree_map
from repro_torch.configs.base import ArchConfig, ShapeCell, applicable_shapes
from repro_torch.dist import sharding as shd
from repro_torch.launch import op_analysis as H
from repro_torch.launch import op_count
from repro_torch.launch.mesh import _mesh, make_production_mesh, make_smoke_mesh
from repro_torch.models import api
from repro_torch.obs import torchprobe
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.train import trainer

DEFAULT_OUT = "experiments/dryrun_torch"
RECORD_LINE = "[dryrun] record "  # then the path of the record written


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def _param_shapes(cfg: ArchConfig, *, tp: int, max_seq: int,
                  device: _device.DeviceLike = "cpu") -> list:
    """The shapes of the parameter tree's leaves, from an init on fake
    tensors."""
    model = api.build_model(cfg, tp=tp, max_seq=max_seq)
    with _fake_mode():
        return [tuple(x.shape) for x in leaves(model.init(0, device=device))]


def count_params(cfg: ArchConfig) -> tuple[float, float]:
    """(N_total, N_active) from the *unpadded* (tp=1) parameter tree."""
    n_total = float(sum(math.prod(s) for s in
                        _param_shapes(cfg, tp=1, max_seq=8)))
    n_active = n_total
    if cfg.moe is not None:
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        per_expert = 3 * cfg.d_model * cfg.moe.d_ff_expert
        n_active -= cfg.n_layers * (e - k) * per_expert
    return n_total, n_active


def model_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    n_total, n_active = count_params(cfg)
    tokens = cell.global_batch * (
        cell.seq_len if cell.kind in ("train", "prefill") else 1
    )
    per_token = 6.0 * n_active if cell.kind == "train" else 2.0 * n_active
    return per_token * tokens


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------


def fake_world(n: int) -> None:
    """Make this process rank 0 of a `"fake"` process group of at least
    `n` ranks (kept where one is up; raises under a real group)."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"the dry-run needs a fake process group, but a "
                f"{dist.get_backend()!r} one is up")
        if dist.get_world_size() >= n:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())


def close_fake_world() -> None:
    """Take down the fake process group, if one is up."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def mesh_name(mesh) -> str:
    """The records' directory of a mesh: "singlepod_16x16",
    "multipod_2x16x16", or "mesh_DxM" / "multipod_PxDxM" for another
    shape."""
    shape = tuple(shd.axis_sizes(mesh).values())
    name = "x".join(str(v) for v in shape)
    if len(shape) == 3:
        return f"multipod_{name}"
    return f"singlepod_{name}" if shape == (16, 16) else f"mesh_{name}"


def make_mesh(multi_pod: bool, shape: Optional[tuple] = None,
              device: _device.DeviceLike = None):
    """The production mesh, or a ("data", "model") mesh of `shape` (D, M)
    — ("pod", "data", "model") for (P, D, M) — over the first ranks of the
    fake group (brought up to its size)."""
    n = math.prod(shape) if shape else (512 if multi_pod else 256)
    fake_world(n)
    if shape and len(shape) == 3:
        return _mesh(shape, ("pod", "data", "model"), device,
                     f"a {'x'.join(map(str, shape))} mesh")
    if shape:
        return make_smoke_mesh(*shape, device=device)
    return make_production_mesh(multi_pod=multi_pod, device=device)


# ---------------------------------------------------------------------------
# Building one cell
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Lowered:
    """One cell ready to count: the step, its arguments (this rank's
    blocks, fake tensors of `mode`), the placed bytes of each argument,
    and which argument the step updates in place (the reference's
    donated one; None: none)."""

    fn: Callable
    args: tuple
    mode: Any
    arg_bytes: dict
    donate: Optional[int]


def _bf16_params(params: Any) -> Any:
    return tree_map(
        lambda x: x.to(torch.bfloat16) if x.dtype == torch.float32 else x,
        params)


def _in_context(cfg, mesh, p_specs, fn: Callable) -> Callable:
    def run(*args):
        with shd.activation_context(cfg, mesh, specs=p_specs):
            return fn(*args)

    return run


def _fake_inputs(tree: Any, dev: torch.device) -> Any:
    """Zero-filled fake tensors of the "meta" `input_specs` tree."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype, device=dev),
                    tree)


def _specs_of(shardings: Any) -> Any:
    return tree_map(lambda s: None if s is None else s.spec, shardings)


def lower_cell(
    cfg: ArchConfig,
    cell: ShapeCell,
    mesh,
    *,
    serve_quant_bits: Optional[int] = None,
    device: _device.DeviceLike = None,
) -> Lowered:
    """Build one cell on fake tensors: the model, its params (bf16 for
    serving, or packed at `serve_quant_bits`; float32 masters and AdamW
    moments to train), the placement and the step's inputs."""
    dev = _device.resolve(device)
    tp = shd.axis_sizes(mesh).get("model", 1) if cfg.use_tp else 1
    model = api.build_model(cfg, tp=tp, max_seq=cell.seq_len)
    specs = api.input_specs(cfg, cell, tp=tp)
    mode = _fake_mode()
    with mode:
        params = model.init(0, device=dev)
        if cell.kind == "train":
            return _lower_train(cfg, model, mesh, params,
                                _fake_inputs(specs["batch"], dev), mode)
        if serve_quant_bits:
            from repro_torch.serve.engine import quantize_for_serving

            params = quantize_for_serving(params, serve_quant_bits)
        else:
            params = _bf16_params(params)
        p_specs = shd.param_specs(params, cfg, mesh)
        placed = shd.place(params, p_specs, mesh)
        arg_bytes = {"params": shd.bytes_per_device(params, p_specs, mesh)}
        if cell.kind == "prefill":
            names = ("tokens", "frames") if cfg.is_enc_dec else ("tokens",)
            donate, fn = None, model.prefill
            args: list = [placed]
        else:  # decode
            names, donate, fn = ("token", "pos"), 1, model.decode_step
            cache = _fake_inputs(specs["cache"], dev)
            c_specs = shd.cache_specs(cache, cfg, mesh)
            arg_bytes["cache"] = shd.bytes_per_device(cache, c_specs, mesh)
            args = [placed, shd.place(cache, c_specs, mesh)]
        inputs = {k: _fake_inputs(specs[k], dev) for k in names}
        b_specs = shd.batch_specs(inputs, cfg, mesh)
        arg_bytes["inputs"] = shd.bytes_per_device(inputs, b_specs, mesh)
        local = shd.place(inputs, b_specs, mesh)
        args += [local[k] for k in names]
    return Lowered(fn=_in_context(cfg, mesh, p_specs, fn), args=tuple(args),
                   mode=mode, arg_bytes=arg_bytes, donate=donate)


def _lower_train(cfg, model, mesh, params, batch, mode) -> Lowered:
    opt = adamw(linear_warmup_cosine(3e-4, 200, 10_000))
    shapes = {"params": params, "opt": opt.init(params),
              "step": torch.zeros((), dtype=torch.int32,
                                  device=leaves(params)[0].device)}
    n_micro = cfg.train_microbatches
    if "pod" in shd.axis_sizes(mesh):
        shapes["err"] = {}
        step, s_shard = trainer.make_multipod_train_step(
            model.loss, opt, cfg, mesh, shapes, compress=False,
            n_micro=n_micro, replicate_indivisible=True)
        b_specs = shd.batch_specs(batch, cfg, mesh)
    else:
        step, s_shard, b_shard = trainer.make_sharded_train_step(
            model.loss, opt, cfg, mesh, shapes, batch, n_micro=n_micro,
            replicate_indivisible=True)
        b_specs = _specs_of(b_shard)
    s_specs = _specs_of(s_shard)
    state = shd.place(shapes, s_specs, mesh)
    arg_bytes = {
        "state": shd.bytes_per_device(shapes, s_specs, mesh),
        # the step is handed the global batch and runs its rows: the
        # rows are what a device holds
        "inputs": shd.bytes_per_device(batch, b_specs, mesh),
    }
    return Lowered(fn=step, args=(state, batch), mode=mode,
                   arg_bytes=arg_bytes, donate=0)


# ---------------------------------------------------------------------------
# Counting it
# ---------------------------------------------------------------------------


def _storages(tree) -> dict:
    """StorageImpl -> bytes of the distinct storages under `tree`."""
    out = {}
    for t in torchprobe._tensors(tree):
        s = t.untyped_storage()
        out[s._cdata] = s.nbytes()
    return out


def analyze(lowered: Lowered, cfg: ArchConfig, cell: ShapeCell, mesh) -> dict:
    """Run the cell's step once and make its record (the reference's
    keys)."""
    n_dev = math.prod(shd.axis_sizes(mesh).values())
    with lowered.mode:
        wc = op_count.count_step(lowered.fn, *lowered.args)
    arg_bytes = int(sum(lowered.arg_bytes.values()))
    held = _storages(lowered.args)
    outs = _storages(wc.output)
    output_bytes = int(sum(outs.values()))
    alias_bytes = 0
    if lowered.donate is not None:
        donated = _storages(lowered.args[lowered.donate])
        alias_bytes = int(sum(v for k, v in outs.items() if k in donated))
    new_out = sum(v for k, v in outs.items() if k not in held)
    temp_bytes = int(max(0, wc.peak_bytes - sum(held.values()) - new_out))
    mf = model_flops(cfg, cell)
    terms = H.roofline_terms(
        per_device_flops=wc.flops,
        per_device_bytes=wc.bytes_accessed,
        per_device_collective_bytes=wc.collective_bytes,
        model_flops_total=mf,
        n_devices=n_dev,
        per_device_arg_bytes=float(arg_bytes),
    )
    return {
        "arch": cfg.name,
        "shape": cell.name,
        "kind": cell.kind,
        "mesh": dict(shd.axis_sizes(mesh)),
        "n_devices": n_dev,
        "memory": {
            "argument_bytes": arg_bytes,
            "argument_bytes_by_kind": dict(lowered.arg_bytes),
            "output_bytes": output_bytes,
            "temp_bytes": temp_bytes,
            "alias_bytes": alias_bytes,
            "total_per_device_bytes": int(
                arg_bytes + output_bytes + temp_bytes - alias_bytes),
            "peak_live_bytes": int(wc.peak_bytes),
            "bf16_emulation_bytes": 0,
        },
        "cost": {
            "per_device_flops": wc.flops,
            "per_device_bytes_accessed": wc.bytes_accessed,
            "kernel_launches": wc.kernel_launches,
            "loops": wc.loops,
            "top_bytes": [list(t) for t in wc.top_bytes],
            "top_flops": [list(t) for t in wc.top_flops],
        },
        "collectives": {
            "bytes_by_op": wc.collective_by_op,
            "count_by_op": wc.collective_counts,
            "total_bytes": wc.collective_bytes,
        },
        "roofline": terms,
    }


def run_cell(
    arch: str,
    shape: str,
    multi_pod: bool,
    out_dir: str,
    *,
    spe_bits: Optional[int] = None,
    spe_sparse: bool = False,
    serve_quant_bits: Optional[int] = None,
    tag: str = "",
    overrides: Optional[dict] = None,
    reduced: bool = False,
    batch: Optional[int] = None,
    seq: Optional[int] = None,
    mesh_shape: Optional[tuple] = None,
    device: _device.DeviceLike = None,
) -> dict:
    """Count one cell and write its record. `reduced` takes the arch's
    reduced config; `batch` / `seq` replace the shape's global batch and
    sequence length; `mesh_shape` (D, M) a ("data", "model") mesh in place
    of the production one."""
    cfg = configs.reduced(arch) if reduced else configs.get(arch)
    if spe_bits is not None or spe_sparse:
        cfg = dataclasses.replace(
            cfg, spe_bits=spe_bits, spe_sparse=spe_sparse
        )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = configs.SHAPES[shape]
    if batch is not None or seq is not None:
        cell = dataclasses.replace(
            cell, global_batch=batch or cell.global_batch,
            seq_len=seq or cell.seq_len)
    mesh = make_mesh(multi_pod, mesh_shape, device)
    t0 = time.monotonic()
    lowered = lower_cell(cfg, cell, mesh, serve_quant_bits=serve_quant_bits,
                         device=device)
    rec = analyze(lowered, cfg, cell, mesh)
    dt = time.monotonic() - t0
    rec["compile_s"] = dt
    rec["serve_quant_bits"] = serve_quant_bits
    rec["spe_bits"] = spe_bits
    rec["spe_sparse"] = spe_sparse
    rec["device"] = _device.resolve(device).type
    name = rec["mesh_name"] = mesh_name(mesh)
    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{cfg.name.replace('/', '_')}__{shape}{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    mem = rec["memory"]["total_per_device_bytes"]
    print(
        f"[dryrun] {cfg.name:24s} {shape:12s} {name:18s} "
        f"count={dt:6.1f}s mem/dev={mem / 2**30:6.2f}GiB "
        f"dominant={rec['roofline']['dominant']:10s} "
        f"frac={rec['roofline']['roofline_fraction']:.3f}",
        flush=True,
    )
    print(f"{RECORD_LINE}{path}", flush=True)
    return rec


def reanalyze(out_dir: str) -> None:
    """Recompute the roofline of every stored record from its counts (no
    step is run) and refresh it in place."""
    n = 0
    for fn in sorted(glob.glob(os.path.join(out_dir, "*", "*.json"))):
        with open(fn) as f:
            rec = json.load(f)
        rec["roofline"] = H.roofline_terms(
            per_device_flops=rec["cost"]["per_device_flops"],
            per_device_bytes=rec["cost"]["per_device_bytes_accessed"],
            per_device_collective_bytes=rec["collectives"]["total_bytes"],
            model_flops_total=rec["roofline"]["model_flops_total"],
            n_devices=rec["n_devices"],
            per_device_arg_bytes=float(rec["memory"]["argument_bytes"]),
        )
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
    print(f"[dryrun] reanalyzed {n} cells")


def _mesh_shape(spec: Optional[str]) -> Optional[tuple]:
    """"D", "DxM" or "PxDxM" -> the mesh's shape (a 1-D spec: (D, 1))."""
    if spec is None:
        return None
    shape = tuple(int(x) for x in spec.lower().split("x"))
    return shape if len(shape) > 1 else (shape[0], 1)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", type=str, default=None,
                    help="arch id (e.g. qwen3-8b); default: all")
    ap.add_argument("--shape", type=str, default=None,
                    help="shape cell; default: all applicable")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", type=str, default=DEFAULT_OUT)
    ap.add_argument("--spe-bits", type=int, default=None)
    ap.add_argument("--spe-sparse", action="store_true")
    ap.add_argument("--serve-quant-bits", type=int, default=None)
    ap.add_argument("--kv-quant-bits", type=int, default=None)
    ap.add_argument("--moe-shard", type=str, default=None)
    ap.add_argument("--loss-chunk", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' reduced configs")
    ap.add_argument("--batch", type=int, default=None,
                    help="replace the shape's global batch")
    ap.add_argument("--seq", type=int, default=None,
                    help="replace the shape's sequence length")
    ap.add_argument("--mesh-shape", type=str, default=None,
                    metavar="DxM|PxDxM",
                    help="a (data, model) or (pod, data, model) mesh in "
                         "place of --mesh")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the fake tensors' device (default: the card; "
                         "raises without one)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="count the cells in this many processes at once "
                         "(one cell a process, each with its own fake "
                         "group)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--reanalyze", action="store_true",
                    help="recompute the stored records' rooflines")
    return ap


def overrides_of(args) -> dict:
    overrides = {}
    if args.kv_quant_bits is not None:
        overrides["kv_quant_bits"] = args.kv_quant_bits
    if args.moe_shard is not None:
        overrides["moe_shard"] = args.moe_shard
    if args.loss_chunk is not None:
        overrides["loss_chunk"] = args.loss_chunk
    if args.microbatches is not None:
        overrides["train_microbatches"] = args.microbatches
    return overrides


def _cost_guess(cell: tuple) -> float:
    """A cell's relative count time, to start the longest first: ops grow
    with depth, and a train step runs forward and backward over every
    token."""
    arch, shape, multi = cell
    cfg, c = configs.get(arch), configs.SHAPES[shape]
    tokens = c.seq_len if c.kind != "decode" else 64
    return cfg.n_layers * tokens * (3 if c.kind == "train" else 1)


def _run_jobs(todo: list, argv: list, jobs: int) -> tuple[list, list]:
    """Each cell of `todo` in a process of its own (`python -m
    repro_torch.launch.dryrun` with `argv`'s flags and the cell's arch,
    shape and mesh), `jobs` at once, the longest first; returns (records,
    failures) as the serial loop does, each record read from the path its
    process printed."""
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    drop = {"--arch", "--shape", "--mesh", "--jobs"}
    keep, it = [], iter(argv)
    for a in it:
        flag = a.split("=")[0]
        if flag in drop:
            if "=" not in a:
                next(it, None)
            continue
        keep.append(a)

    def one(cell):
        a, s, mp = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *keep,
               "--arch", a, "--shape", s, "--mesh",
               "multi" if mp else "single"]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("[dryrun] ")]
        paths = [ln[len(RECORD_LINE):] for ln in lines
                 if ln.startswith(RECORD_LINE)]
        print(lines[0] if proc.returncode == 0 and paths
              else proc.stdout[-3000:], flush=True)
        return cell, proc.returncode, paths

    records, failures = [], []
    with ThreadPoolExecutor(jobs) as pool:
        for (a, s, mp), rc, paths in pool.map(
                one, sorted(todo, key=_cost_guess, reverse=True)):
            if rc or not paths:
                failures.append((a, s, mp, f"exit {rc}"))
                continue
            with open(paths[0]) as f:
                records.append(json.load(f))
    return records, failures


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Count the cells `argv` selects; returns their records."""
    args = parser().parse_args(argv)
    if args.reanalyze:
        reanalyze(args.out)
        return []
    archs = [args.arch] if args.arch else list(configs.CLI_IDS.keys())
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    mesh_shape = _mesh_shape(args.mesh_shape)
    if mesh_shape:
        meshes = [False]
    todo = []
    for a in archs:
        cfg = configs.get(a)
        cells = ([configs.SHAPES[args.shape]] if args.shape
                 else applicable_shapes(cfg))
        for c in cells:
            for mp in meshes:
                todo.append((a, c.name, mp))
    if args.list:
        for a, s, mp in todo:
            print(a, s, "multi" if mp else "single")
        print(f"{len(todo)} cells")
        return []

    device = args.device
    _device.resolve(device)  # no fake card without a real one
    t_all = time.monotonic()
    if args.jobs > 1 and len(todo) > 1:
        records, failures = _run_jobs(
            todo, list(sys.argv[1:] if argv is None else argv), args.jobs)
    else:
        fake_world(math.prod(mesh_shape) if mesh_shape
                   else 512 if any(mp for _, _, mp in todo) else 256)
        records, failures = [], []
        for a, s, mp in todo:
            try:
                records.append(run_cell(
                    a, s, mp, args.out,
                    spe_bits=args.spe_bits, spe_sparse=args.spe_sparse,
                    serve_quant_bits=args.serve_quant_bits, tag=args.tag,
                    overrides=overrides_of(args), reduced=args.reduced,
                    batch=args.batch, seq=args.seq, mesh_shape=mesh_shape,
                    device=device,
                ))
            except Exception as e:  # noqa: BLE001 — report all at the end
                failures.append((a, s, mp, repr(e)))
                print(f"[dryrun] FAIL {a} {s} "
                      f"{'multi' if mp else 'single'}: {e}")
                traceback.print_exc()
    print(f"\n[dryrun] {len(todo) - len(failures)}/{len(todo)} cells passed "
          f"in {time.monotonic() - t_all:.1f}s")
    if failures:
        for f in failures:
            print("  FAIL:", *f)
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()

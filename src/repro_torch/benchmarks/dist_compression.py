"""Cross-pod gradient reduction: scheme x pod-count sweep + convergence
(port of `benchmarks/dist_compression.py`).

Measures, on the trainer's actual gradient tree (a reduced LM config's
parameter tree), the three cross-pod reduction paths of
`repro_torch.dist.compression` over pod groups of the process group's
ranks (one rank a pod: gloo ranks on the CPU, one NCCL rank a card):

  * sweep (n_pods in {2, 4, 8} that the group holds x {uncompressed,
    gather, two_stage}) — two views of the bytes on the wire: the bytes
    each rank hands to its collectives, counted on the compression
    functions (`compression.wire_bytes`; the reference parses them from
    the compiled HLO, which this port has no counterpart of), and the
    modelled per-rank ring egress:
      - f32 ring all-reduce:  2*(n-1)/n * 4B * |leaf|
      - int8 full-leaf gather: (n-1) * (|leaf| + 4B)      -> (8/n)x
      - int8 two-stage (reduce-scatter + all-gather):
        2*(n-1)/n * |leaf_padded| + 8B*(n-1)              -> ~4x, any n
    plus the wall time of a call (on the CPU: gloo over loopback,
    structural sanity, not a data-centre network).
  * convergence — short compressed-DP training runs of the reduced
    config (`trainer.make_dp_step_compressed` over a pod group of every
    rank) per scheme, recording the loss curve.

Checked here (`check`), as the reference states it:
  * the two-stage egress ratio against f32 is ~4x and independent of the
    pod count (spread < 10% across n);
  * gather decays like 8/n (> 3.5x at the fewest pods, < 1.3x at 8);
  * both int8 schemes hand fewer bytes to their collectives than f32;
  * every scheme's loss curve decreases, the compressed finals within
    tolerance of the f32 baseline;
  * the step-latency histogram of the convergence runs is recorded.

The record is printed and written as JSON only where `--out` says: never
to the repository's BENCH_dist.json, which holds the JAX package's runs.

    python -m repro_torch.benchmarks.dist_compression --devices 8 [--smoke]

`main(argv, device="cpu")` runs it over gloo ranks on the CPU; with no
`device` it needs a card a rank.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from repro_torch import _device, configs, obs, optim
from repro_torch._tree import leaves, tree_map
from repro_torch.data import lm
from repro_torch.dist import compression as C
from repro_torch.launch import _spawn
from repro_torch.launch.mesh import make_multipod_mesh
from repro_torch.models import api
from repro_torch.train import trainer

SCHEMES = ("uncompressed", "gather", "two_stage")


def grad_tree(arch: str, device: _device.DeviceLike = None):
    """The trainer's gradient tree: one autograd pass of the reduced
    config's loss (grads mirror the f32 param tree)."""
    dev = _device.resolve(device)
    cfg = configs.reduced(arch)
    model = api.build_model(cfg, tp=1, max_seq=32)
    params = model.init(0, device=dev)
    gen = torch.Generator().manual_seed(1)
    batch = {
        "tokens": torch.randint(0, cfg.vocab, (4, 16), generator=gen),
        "targets": torch.randint(0, cfg.vocab, (4, 16), generator=gen),
    }
    if cfg.is_enc_dec:
        batch["frames"] = torch.randn((4, cfg.enc_seq, cfg.d_model),
                                      generator=gen)
    batch = {k: v.to(dev) for k, v in batch.items()}
    grads, _ = trainer._grad_fn(model.loss)(params, batch)
    return cfg, grads


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def modeled_egress(grads, n: int) -> dict:
    """Per-rank ring-collective egress bytes for one reduction of the
    tree under each scheme (docstring formulas)."""
    sizes = [x.numel() for x in leaves(grads)]
    pad = lambda s: -(-s // n) * n  # noqa: E731
    unc = sum(2 * (n - 1) / n * 4 * s for s in sizes)
    gather = sum((n - 1) * (s + 4) for s in sizes)
    two = sum(2 * (n - 1) / n * pad(s) + 8 * (n - 1) for s in sizes)
    return {
        "uncompressed": unc,
        "gather": gather,
        "two_stage": two,
        "ratio_gather": unc / gather,
        "ratio_two_stage": unc / two,
    }


def _reduction(scheme: str, grads, group, n: int):
    """A call of one reduction over `group` on fresh error buffers."""
    zeros = lambda: tree_map(torch.zeros_like, grads)  # noqa: E731
    if scheme == "uncompressed":
        return lambda: C.uncompressed_psum_mean(grads, group)
    if scheme == "gather":
        return lambda: C.compressed_psum_mean(grads, zeros(), group)
    if scheme == "two_stage":
        return lambda: C.two_stage_psum_mean(
            grads, zeros(),
            tree_map(lambda g: torch.zeros(
                C.two_stage_shard_len(g.numel(), n), device=g.device),
                grads),
            group)
    raise ValueError(scheme)


def _sync(out) -> None:
    obs.synchronize(leaves(out[0] if isinstance(out, tuple) else out))


def _time_call(fn, reps: int = 10) -> float:
    _sync(fn())  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _sync(out)
    return (time.perf_counter() - t0) / reps


def sweep(grads, pod_counts, device: _device.DeviceLike = None) -> list:
    """Every (n_pods, scheme) cell on the pod group of the first n ranks;
    every rank calls it, rank 0's cells are returned."""
    cells = []
    for n in pod_counts:
        mesh = make_multipod_mesh(f"{n}x1", device)
        if mesh.get_coordinate() is None:
            continue
        group = mesh.get_group("pod")
        eg = modeled_egress(grads, n)
        for scheme in SCHEMES:
            fn = _reduction(scheme, grads, group, n)
            C.reset_wire()
            fn()
            handed = sum(C.wire_bytes.values())
            by_op = dict(C.wire_bytes)
            calls = dict(C.wire_calls)
            cells.append({
                "n_pods": n,
                "scheme": scheme,
                "modeled_egress_bytes_per_device": eg[scheme],
                "modeled_ratio_vs_f32": eg["uncompressed"] / eg[scheme],
                "collective_bytes": handed,
                "collective_bytes_by_op": by_op,
                "collective_calls_by_op": calls,
                "wall_s_per_call": _time_call(fn),
            })
            if _spawn.rank() == 0:
                print(
                    f"[dist_compression] n={n} {scheme:>12}: "
                    f"egress/device={eg[scheme] / 2**20:7.2f}MiB "
                    f"({eg['uncompressed'] / eg[scheme]:4.2f}x vs f32)  "
                    f"handed={handed / 2**20:7.2f}MiB  "
                    f"wall={cells[-1]['wall_s_per_call'] * 1e3:6.2f}ms",
                    flush=True,
                )
    return cells


def convergence(arch: str, steps: int,
                device: _device.DeviceLike = None) -> dict:
    """Wire ratio against loss curve: train the reduced config with each
    reduction scheme over a pod group of every rank."""
    dev = _device.resolve(device)
    n = _spawn.world_size()
    mesh = make_multipod_mesh(f"{n}x1", dev)
    cfg = configs.reduced(arch)
    model = api.build_model(cfg, tp=1, max_seq=32)
    tel = obs.get()
    step_hist = tel.registry.histogram("train.step_latency_s")
    curves = {}
    for mode in ("f32", "gather", "two_stage"):
        compress = mode != "f32"
        scheme = mode if compress else "gather"
        params = model.init(0, device=dev)
        opt = optim.adamw(3e-3)
        state = trainer.init_state(params, opt, device=dev)
        state["err"] = trainer.init_dp_err(
            state["params"], mesh, scheme=scheme, compress=compress)
        step = tel.probe.track(
            f"train.dp_step.{mode}",
            trainer.make_dp_step_compressed(
                model.loss, opt, mesh, scheme=scheme, compress=compress),
        )
        stream = lm.TokenStream(batch=8, seq_len=16, vocab=cfg.vocab,
                                seed=0, device=dev)
        losses = []
        for i in range(steps):
            t0 = time.perf_counter()
            with tel.span("train/step", cat="train", mode=mode, step=i):
                state, m = step(state, stream.batch_at(i))
                losses.append(round(float(m["loss"]), 6))
            step_hist.observe(time.perf_counter() - t0)
        curves[mode] = losses
        if _spawn.rank() == 0:
            print(
                f"[dist_compression] convergence {mode:>9}: "
                f"loss {losses[0]:.4f} -> {losses[-1]:.4f} ({steps} steps, "
                f"n_pods={n})", flush=True,
            )
    return {
        "arch": cfg.name, "n_pods": n, "steps": steps, "batch": 8,
        "curves": curves,
        "final": {k: v[-1] for k, v in curves.items()},
    }


def _require(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


def check(rec: dict) -> None:
    """The reference's gates, with the handed bytes in place of the HLO
    collective bytes."""
    two = {c["n_pods"]: c["modeled_ratio_vs_f32"]
           for c in rec["sweep"] if c["scheme"] == "two_stage"}
    gather = {c["n_pods"]: c["modeled_ratio_vs_f32"]
              for c in rec["sweep"] if c["scheme"] == "gather"}
    # two-stage: ~4x below f32, independent of pod count
    for n, r in two.items():
        _require(3.5 < r < 4.3, ("two_stage ratio", n, r))
    spread = (max(two.values()) - min(two.values())) / min(two.values())
    _require(spread < 0.10, ("two_stage not n-independent", two))
    # gather: (8/n)x decay — wins at n=2, dead by n=8
    _require(gather[min(gather)] > 3.5, gather)
    if 8 in gather:
        _require(gather[8] < 1.3, gather)
    # the int8 schemes hand fewer bytes to their collectives than f32
    by_key = {(c["n_pods"], c["scheme"]): c for c in rec["sweep"]}
    for (n, scheme), c in by_key.items():
        if scheme == "uncompressed":
            continue
        unc = by_key[(n, "uncompressed")]["collective_bytes"]
        _require(0 < c["collective_bytes"] < unc, (n, scheme))
    # convergence: every curve trains; compression stays near baseline
    cv = rec["convergence"]["curves"]
    for mode, losses in cv.items():
        _require(losses[-1] < losses[0] - 0.05,
                 (mode, losses[0], losses[-1]))
    f32_final = cv["f32"][-1]
    drop = cv["f32"][0] - f32_final
    for mode in ("gather", "two_stage"):
        _require(abs(cv[mode][-1] - f32_final) < max(0.25 * drop, 0.05),
                 (mode, cv[mode][-1], f32_final))
    t = rec["telemetry"]
    _require(t["schema_version"] == obs.SCHEMA_VERSION and t["enabled"], t)
    h = t["histograms"]["train.step_latency_s"]
    _require(h["count"] > 0 and None not in (h["p50"], h["p99"], h["p999"]),
             h)
    for mode in ("f32", "gather", "two_stage"):
        _require(f"train.dp_step.{mode}" in t["recompiles"],
                 (mode, t["recompiles"]))


def run(arch: str = "qwen3_8b", *, steps: int = 60,
        out: Optional[str] = None,
        device: _device.DeviceLike = None) -> Optional[dict]:
    """The sweep and the convergence runs on every rank of the process
    group; rank 0 checks, prints and returns the record (the others
    None)."""
    dev = _device.resolve(device)
    world = _spawn.world_size()
    pod_counts = [n for n in (2, 4, 8) if n <= world]
    if not pod_counts:
        raise SystemExit(
            f"dist_compression needs >= 2 ranks for the scheme sweep but "
            f"the process group has {world} (--devices)"
        )
    # before the steps are built, so they register with the probe
    obs.configure(enabled=True)
    cfg, grads = grad_tree(arch, dev)
    rec = {
        "benchmark": "dist_compression",
        "arch": cfg.name,
        "device": {"type": dev.type,
                   "name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")},
        "n_ranks": world,
        "grad_leaves": len(leaves(grads)),
        "grad_bytes": _nbytes(grads),
        "sweep": sweep(grads, pod_counts, dev),
        "convergence": convergence(arch, steps, dev),
        "telemetry": obs.telemetry_section(),
    }
    if _spawn.rank() != 0:
        return None
    check(rec)
    rec["checked"] = True
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[dist_compression] all gates passed -> {out}")
    else:
        print("[dist_compression] all gates passed")
    return rec


def main(argv: Optional[Sequence[str]] = None,
         device: _device.DeviceLike = None) -> Optional[dict]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks (pods) to bring up, one a device")
    ap.add_argument("--out", default=None,
                    help="write the JSON record here (default: nowhere)")
    ap.add_argument("--smoke", action="store_true",
                    help="fewer convergence steps")
    args = ap.parse_args(argv)
    dev = _device.resolve(device)
    return _spawn.run(run, args.devices, device=dev.type, kwargs=dict(
        arch=args.arch, steps=24 if args.smoke else 60, out=args.out,
        device=dev.type))


if __name__ == "__main__":
    main()

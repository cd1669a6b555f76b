"""Serving launcher: batched LM generation, or the VA diagnosis service, on
the card (port of `repro.launch.serve`).

    python -m repro_torch.launch.serve --arch qwen3-8b \\
        [--batch 4 --prompt-len 16 --max-new 16] [--quant-bits 8] \\
        [--temperature 0.8 --top-k 40] [--reduced]
    python -m repro_torch.launch.serve --arch va-cnn --patients 8

Without `--reduced` the LM runs the architecture's full `CONFIG` (for
qwen3-8b: 36 layers, d_model 4096, vocab 151936; every decoder-only
config in `configs/`, the MoE, RG-LRU and RWKV-6 families included) from
random weights drawn on the card from `--seed`. `--quant-bits` packs
every projection (`serve.engine.quantize_for_serving`: the routed MoE
experts, the router and RG-LRU's gates stay dense) and drops the float32
master weights; the packed projections then run the hand-written
`quant_matmul` kernel. Greedy by default; `--temperature` enables
per-request keyed sampling (reproducible for a fixed `--seed`). An
encoder-decoder config (whisper-tiny) raises
`serve.engine.EncDecUnsupportedError` from `generate`, as in the
reference.

Async serving frontend (`serve.frontend`): `--listen HOST:PORT` serves
the length-prefixed JSON transport over the slot engine (unquantized
params, as in the reference: `--quant-bits` does not apply), with
admission control at `--admission-rate`, the paged cache at
`--page-size` / `--pages-per-device` and chunked prefill at
`--chunk-tokens`; it prints the bound address and serves until SIGINT.
`--connect HOST:PORT` drives it open-loop from another process:
`--load-requests` requests at `--offered-rate` req/s on `--arrival-process`
arrivals. With `--mesh`, the server fronts the sharded engine
(`serve.sharded.ShardedEngine`, the paged pool `(batch / D) x span + 1`
pages a device, as in the reference) on ranks spawned as for generate:
rank 0 owns the socket and prints the address, and the other ranks
replay its driver's records (`serve.frontend.Frontend.follow`); SIGINT to
the launcher stops every rank.

    python -m repro_torch.launch.serve --arch qwen3-8b --listen 127.0.0.1:0 \
        --batch 4 --prompt-len 48 --max-new 16 --page-size 16 \
        --chunk-tokens 16 [--mesh 1]
    python -m repro_torch.launch.serve --arch qwen3-8b --connect HOST:PORT \
        --load-requests 12 --offered-rate 4 --prompt-len 48 --max-new 16

Sharded generation (`serve.sharded`): `--mesh D` (data-parallel over D
devices) or `--mesh DxM` (and tensor-parallel over M) runs the same
generate on a ("data", "model") mesh, one process a device: ranks are
spawned here through `launch._spawn.run` (gloo on the CPU, NCCL one a
card), or are the caller's or `torchrun`'s. Every rank builds the params
from `--seed`, keeps its block (`place_params`) and frees the rest; rank
0 prints the plan's per-device bytes and returns the record.

    python -m repro_torch.launch.serve --arch qwen3-8b --quant-bits 8 \
        --mesh 1
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch qwen3-8b --mesh 2x2

Open-loop offered-load sweeps (`obs.loadlab`), on the dense weights as
in the reference (`--quant-bits` does not apply): `--load-sweep` measures
the slot engine's closed-loop capacity, then offers `--load-fractions`
of it on `--arrival-process` arrivals, `--load-requests` requests a
point, and reports tail latency from *intended* arrival, the knee, the
TTFT SLO's burn and the overload verdict; `--frontend-sweep` offers them
through the frontend over a loopback socket with admission control at
`--admission-rate` (default: the measured capacity) — the shed-rate
curve, URGENT segment survival, the verdict and the socket-vs-inproc
tail. Both honour `--page-size`, `--pages-per-device` and
`--chunk-tokens`, return the sweep record and print it with `--json`
(render it with `python -m repro_torch.obs.loadlab RECORD.json`). With
`--mesh` they drive the sharded engine, built once on every rank (each
keeps its blocks), on ranks spawned as for generate: rank 0 runs the
sweep and sends each tick's submits and tick, and each frontend it
builds, to the other ranks before acting on them
(`serve.frontend.RecordedEngine`), which replay them
(`serve.frontend.follow_sweep`); rank 0's record comes back.

    python -m repro_torch.launch.serve --arch recurrentgemma-2b \
        --load-sweep --load-requests 8 --max-new 4 --load-fractions 0.5,1,4
    python -m repro_torch.launch.serve --arch qwen3-8b --reduced \
        --frontend-sweep --json [--mesh 2x2]

`main(argv, device="cpu")` runs the same paths on the CPU; with no
`device` it needs a card.
"""

from __future__ import annotations

import argparse
import json
import signal
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import _device, configs, obs
from repro_torch.dist import sharding as shd
from repro_torch.launch import _spawn
from repro_torch.launch.mesh import make_serving_mesh, parse_mesh_spec
from repro_torch.models import api
from repro_torch.serve import engine as E
from repro_torch.serve import sharded as SH

def build_lm(args, device: _device.DeviceLike = None):
    """(cfg, model, params, prompts) of one `serve_lm` run: the config
    (full or `--reduced`), params drawn on `device` from `--seed` (packed
    at `--quant-bits`, the master weights dropped), and (batch,
    prompt_len) prompts drawn on the CPU from `--seed`."""
    dev = _device.resolve(device)
    cfg = configs.reduced(args.arch) if args.reduced else configs.get(
        args.arch
    )
    max_seq = args.prompt_len + args.max_new + 1
    model = api.build_model(cfg, tp=1, max_seq=max_seq)
    params = model.init(args.seed, device=dev)
    if args.quant_bits:
        params = E.quantize_for_serving(params, args.quant_bits)
    gen = torch.Generator().manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen).to(dev)
    return cfg, model, params, prompts


def _sampling(args) -> dict:
    return dict(
        greedy=args.temperature is None,
        key=E.fold_in(E.prng_key(args.seed), 1),  # decouple from init/prompts
        # keep an explicit 0.0 (sample_tokens' degenerate-to-greedy case)
        temperature=1.0 if args.temperature is None else args.temperature,
        top_k=args.top_k,
    )


def serve_lm(args, device: _device.DeviceLike = None) -> dict:
    dev = _device.resolve(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, model, params, prompts = build_lm(args, dev)
    build_s = time.perf_counter() - t0
    if args.quant_bits:
        print(f"[serve] weights quantized to {args.quant_bits} bits")
    sampling = _sampling(args)
    if args.temperature is not None:
        print(f"[serve] sampling: temperature={args.temperature} "
              f"top_k={args.top_k or 'off'} (per-request keys)")
    t0 = time.perf_counter()
    with obs.get().span("serve/generate", cat="serve",
                        batch=args.batch, max_new=args.max_new):
        out = E.generate(model, params, prompts, max_new=args.max_new,
                         device=dev, **sampling).cpu()
    dt = time.perf_counter() - t0
    n_tok = args.batch * args.max_new
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"[serve] {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}) on {where}: {tuple(out.shape)} tokens in "
          f"{dt:.2f}s ({n_tok / dt:.1f} tok/s incl. first-use set-up)"
          + (f", peak device memory {peak / 1e9:.2f} GB" if peak else ""))
    print("[serve] sample:", out[0][:12].tolist())
    return {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab, "quant_bits": args.quant_bits,
        "batch": args.batch, "prompt_len": args.prompt_len,
        "max_new": args.max_new, "tokens": out.tolist(),
        "build_s": build_s, "generate_s": dt, "tok_per_s": n_tok / dt,
        "peak_device_bytes": peak, "device": where,
    }


def serve_lm_mesh_rank(args, device: _device.DeviceLike = None):
    """`--mesh` on this rank of the process group (every rank of the mesh
    calls it): the plan, this rank's block of the params (the rest freed),
    `sharded_generate`. Returns rank 0's record — with, under "placed",
    the model, the placed params, the plan and the prompts for a caller
    in this process — or None on the other ranks."""
    dev = _device.resolve(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_serving_mesh(args.mesh, dev)
    if mesh.get_coordinate() is None:
        return None
    lead = _spawn.rank() == 0
    t0 = time.perf_counter()
    cfg, model, params, prompts = build_lm(args, dev)
    plan = SH.plan_decode(model, params, mesh, batch_size=args.batch)
    placed = SH.place_params(params, plan)
    del params  # this rank keeps its block only
    build_s = time.perf_counter() - t0
    if lead:
        sizes = shd.axis_sizes(mesh)
        print(f"[serve] mesh {sizes}: cache "
              f"{plan.cache_bytes_per_device / 1e3:.1f} kB/device "
              f"(replicated would be {plan.cache_bytes_total / 1e3:.1f} "
              f"kB), params {plan.param_bytes_per_device / 1e3:.1f} "
              f"kB/device")
    stats: dict = {}
    t0 = time.perf_counter()
    with obs.get().span("serve/generate", cat="serve", batch=args.batch,
                        max_new=args.max_new, mesh=args.mesh):
        out = SH.sharded_generate(
            model, placed, prompts, mesh=mesh, max_new=args.max_new,
            params_placed=True, plan=plan, stats=stats, **_sampling(args),
        ).cpu()
    dt = time.perf_counter() - t0
    if not lead:
        return None
    n_tok = args.batch * args.max_new
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"[serve] {cfg.name} on mesh {args.mesh} ({dist.get_backend()}, "
          f"{where}): {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s incl. first-use set-up)")
    print("[serve] sample:", out[0][:12].tolist())
    return {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab, "quant_bits": args.quant_bits,
        "batch": args.batch, "prompt_len": args.prompt_len,
        "max_new": args.max_new, "tokens": out.tolist(),
        "mesh": args.mesh, "backend": dist.get_backend(),
        "world": dist.get_world_size(), "n_devices": plan.n_devices,
        "param_bytes_per_device": plan.param_bytes_per_device,
        "cache_bytes_per_device": plan.cache_bytes_per_device,
        "param_bytes_total": plan.param_bytes_total,
        "cache_bytes_total": plan.cache_bytes_total,
        "param_bytes_placed": shd.placed_bytes(placed),
        "cache_bytes_placed": stats["cache_bytes"],
        "decode_wall_ms": stats["decode_wall_ms"],
        "decode_comm": stats["decode_comm"],
        "comm_budget": SH._decode_comm_budget(model),
        "build_s": build_s, "generate_s": dt, "tok_per_s": n_tok / dt,
        "peak_device_bytes": peak, "device": where,
        "placed": {"model": model, "params": placed, "plan": plan,
                   "prompts": prompts},
    }


def _mesh_record(args, device) -> Optional[dict]:
    """`serve_lm_mesh_rank` on a spawned rank: the record without its
    tensors and model (what crosses back to the caller)."""
    out = serve_lm_mesh_rank(args, device)
    if out is not None:
        out.pop("placed")
    return out


def serve_lm_mesh(args, device: _device.DeviceLike = None) -> dict:
    """`--mesh`: ranks spawned for the mesh (or the group that is here)."""
    n_data, n_model = parse_mesh_spec(args.mesh)
    world = n_data * n_model
    fn = _mesh_record if _spawn.spawns(world) else serve_lm_mesh_rank
    dev = "cpu" if _device.resolve(device).type == "cpu" else device
    return _spawn.run(fn, world, device=dev, args=(args, dev))


def _hostport(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return host or "127.0.0.1", int(port)


def _build_lm_engine(args, device: _device.DeviceLike = None):
    """(cfg, make_engine, make_prompts) of a `--listen` server or a sweep:
    the config (full or `--reduced`) with max_seq = prompt + max_new + 2,
    rounded up to a multiple of `--page-size`; dense params drawn on
    `device` from `--seed`; a maker of the slot engine with the paged pool
    and chunked prefill the flags ask for; and `make_prompts(n)`, n
    (prompt_len,) prompts drawn on the CPU from the (seed, 2) stream (the
    reference's `fold_in(key, 2)`). With `--mesh`, the engine is the
    sharded one on this rank of `make_serving_mesh` (every rank of the
    mesh calls this), built here once, so only this rank's blocks of the
    params are kept, and the maker returns it; its paged pool is
    `(batch / D) x span + 1` pages a device."""
    from repro_torch.serve.paging import PagingConfig, validate_page_size

    dev = _device.resolve(device)
    cfg = configs.reduced(args.arch) if args.reduced else configs.get(
        args.arch
    )
    max_seq = args.prompt_len + args.max_new + 2
    page = args.page_size
    if page:
        # a paged pool needs page_size | every attention capacity: round
        # the derived max_seq up instead of bouncing the run
        max_seq += (-max_seq) % page
    model = api.build_model(cfg, tp=1, max_seq=max_seq)
    params = model.init(args.seed, device=dev)
    spec = getattr(args, "mesh", None)
    mesh = make_serving_mesh(spec, dev) if spec else None
    n_data = (shd._axis_size(shd.data_axes(cfg, mesh), mesh)
              if mesh is not None else 1)
    paging = None
    if page:
        per_dev = args.pages_per_device
        if per_dev is None:
            # the dense pool's worth of pages (+1 scratch): paged then
            # never refuses what dense would have seated
            span = validate_page_size(page, model.attn_capacities())
            per_dev = (args.batch // n_data) * span + 1
        paging = PagingConfig(page, per_dev * n_data)
    prompt_seed = int(np.random.SeedSequence([args.seed, 2])
                      .generate_state(1)[0])

    def make_prompts(n: int) -> list:
        gen = torch.Generator().manual_seed(prompt_seed)
        toks = torch.randint(0, cfg.vocab, (n, args.prompt_len),
                             generator=gen)
        return [toks[i] for i in range(n)]

    if mesh is not None:
        # built here, so the maker holds this rank's blocks, not the tree
        sharded = SH.ShardedEngine(
            model, params, batch_size=args.batch, mesh=mesh, paging=paging,
            chunk_tokens=args.chunk_tokens, device=dev)
        del params
        return cfg, lambda: sharded, make_prompts

    def make_engine():
        return E.Engine(model, params, batch_size=args.batch, paging=paging,
                        chunk_tokens=args.chunk_tokens, device=dev)

    return cfg, make_engine, make_prompts


def serve_frontend(fe, listen: str, tag: str, what: str, *,
                   leads_ranks: bool = False, stats=None) -> None:
    """Serve `fe` (built and warmed) on the socket at `listen` until
    SIGINT: print the bound address, and on SIGINT the frontend's stats
    (`stats()`, default `fe.stats()`). Raises when its driver thread
    died. The first SIGINT begins the stop, which is never cut short: a
    later one is a no-op (a terminal's Ctrl-C reaches a rank 0 both
    directly and through the launcher); where the frontend leads ranks
    (`leads_ranks`) that holds until the process ends, so the stop
    reaches every rank."""
    stats = stats or fe.stats
    import asyncio

    host, port = _hostport(listen)
    stop = threading.Event()

    async def amain() -> None:
        bound = await fe.start(host, port)
        print(f"[{tag}] frontend listening on {bound[0]}:{bound[1]} "
              f"({what})", flush=True)
        try:
            while fe.driver_alive() and not stop.is_set():
                await asyncio.sleep(0.2)
        finally:
            await fe.stop()  # raises when the driver died

    old = signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        asyncio.run(amain())
    finally:
        if not leads_ranks:
            signal.signal(signal.SIGINT, old)
    if stop.is_set():
        print(f"[{tag}] frontend stopped: {json.dumps(stats())}",
              flush=True)


def follow(fe, records) -> None:
    """A rank other than 0 of a frontend over a mesh: replay rank 0's
    records until its stop. SIGINT is ignored here: rank 0 stops the
    ranks."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    fe.follow(records)


def _listen_rank(args, device: _device.DeviceLike = None) -> Optional[dict]:
    """`--listen` on this rank (every rank of the mesh calls it with
    `--mesh`): the engine, the record group (`RankRecords`) and the
    warm-up on every rank in lockstep; rank 0 serves the socket until
    SIGINT and returns the stats, the others follow and return None."""
    from repro_torch.serve.frontend import (
        Frontend,
        FrontendConfig,
        RankRecords,
    )

    cfg, make_engine, _ = _build_lm_engine(args, device)
    records = None
    if args.mesh:
        n_data, n_model = parse_mesh_spec(args.mesh)
        if _spawn.world_size() != n_data * n_model:
            raise SystemExit(f"--listen --mesh {args.mesh} runs on exactly "
                             f"{n_data * n_model} ranks, not "
                             f"{_spawn.world_size()}")
        records = RankRecords(_spawn.TIMEOUT_S)
    lead = _spawn.rank() == 0
    engine = make_engine()
    fe = Frontend(engine=engine,
                  cfg=FrontendConfig(admission_rate_rps=args.admission_rate),
                  records=records if lead else None)
    fe.warm(args.prompt_len)
    if not lead:
        follow(fe, records)
        return None
    shd.reset_comm()  # the collectives of the serving, the warm-up's not

    def stats() -> dict:
        out = fe.stats()
        if records is not None:
            out["comm_calls"] = dict(shd.comm_calls)
        if engine.device.type == "cuda":
            out["peak_device_bytes"] = torch.cuda.max_memory_allocated(
                engine.device)
        return out

    serve_frontend(fe, args.listen, "serve", "admission rate: "
                   f"{args.admission_rate or 'unbounded'}"
                   + (f", mesh {args.mesh}" if args.mesh else ""),
                   leads_ranks=records is not None, stats=stats)
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab, "mesh": args.mesh,
            "stats": stats()}


def serve_listen(args, device: _device.DeviceLike = None) -> dict:
    """Serve LM requests over the frontend's socket transport
    (`serve.frontend`), with admission control at --admission-rate (shed
    with typed rejections past it), until SIGINT. Returns the frontend's
    stats; raises when its driver thread died. With `--mesh` the ranks
    are spawned (or are the group's) and rank 0's record comes back."""
    if not args.mesh:
        return _listen_rank(args, device)
    n_data, n_model = parse_mesh_spec(args.mesh)
    dev = "cpu" if _device.resolve(device).type == "cpu" else device
    return _spawn.run(_listen_rank, n_data * n_model, device=dev,
                      args=(args, dev), until_stopped=True)


def serve_connect(args) -> dict:
    """Open-loop socket client: offer --load-requests LM requests at
    --offered-rate req/s and report the terminal outcomes. The prompts are
    drawn below min(1000, vocab): the reference draws below 1000 whatever
    the vocabulary (jnp clamps an out-of-range embedding index; the port's
    engine refuses one)."""
    import asyncio

    from repro_torch.obs import loadlab
    from repro_torch.serve.frontend import SocketClient

    cfg = configs.reduced(args.arch) if args.reduced else configs.get(
        args.arch
    )
    host, port = _hostport(args.connect)
    intended = loadlab.arrival_times(
        args.seed, 0, rate_hz=args.offered_rate, n=args.load_requests,
        process=args.arrival_process,
    )
    hi = min(1000, cfg.vocab)

    def prompt(i: int) -> list:
        rng = np.random.default_rng(np.random.SeedSequence([args.seed,
                                                            100 + i]))
        return rng.integers(0, hi, args.prompt_len).tolist()

    async def amain() -> tuple[list, list, float]:
        client = await SocketClient.connect(host, port)
        futs, sent = [], []
        t0 = time.perf_counter()
        for i in range(args.load_requests):
            delay = intended[i] - (time.perf_counter() - t0)
            if delay > 0:
                await asyncio.sleep(delay)
            sent.append(time.perf_counter())
            futs.append(await client.send_lm(
                uid=i, prompt=prompt(i), max_new=args.max_new
            ))
        results = [await asyncio.wait_for(f, 120.0) for f in futs]
        await client.close()
        return results, [t - t0 for t in sent], t0

    results, sent_s, t0 = asyncio.run(amain())
    wall = time.perf_counter() - t0
    done = sum(1 for r in results if r["status"] == "completed")
    reasons: dict = {}
    for r in results:
        if r["status"] == "rejected":
            reasons[r["reason"]] = reasons.get(r["reason"], 0) + 1
    print(f"[serve] {args.load_requests} offered at "
          f"{args.offered_rate:.1f} req/s -> {done} completed, "
          f"{len(results) - done} rejected {reasons or ''}")
    n_tok = sum(len(r.get("tokens", ())) for r in results)
    return {
        "offered": args.load_requests, "offered_rate": args.offered_rate,
        "completed": done, "rejected": len(results) - done,
        "reasons": reasons, "wall_s": wall, "tokens_total": n_tok,
        "tok_per_s": n_tok / wall,
        "results": [{"uid": r["uid"], "status": r["status"],
                     "tokens": r.get("tokens"), "reason": r.get("reason"),
                     "intended_s": float(intended[r["uid"]]),
                     "sent_s": sent_s[r["uid"]],
                     "latency_s": r["_t_recv"] - t0 - float(
                         intended[r["uid"]])}
                    for r in results],
    }


def _fractions(args) -> tuple:
    return tuple(float(f) for f in args.load_fractions.split(","))


def _load_sweep(args, make_engine, make_prompts) -> dict:
    """Open-loop offered-load sweep over the slot engine (wall time):
    measure the closed-loop capacity, then drive Poisson/trace-driven
    arrival schedules at fractions of it and report tail latency from
    *intended* arrival times, the saturation knee, TTFT SLO burn, and
    the overload verdict (see `obs.loadlab`). Returns the sweep record."""
    from repro_torch.obs import loadlab

    cap = loadlab.run_serve_point(
        make_engine,
        make_prompts(max(2 * args.batch, 8)),
        rate_rps=1e5,  # everything intended at ~t=0: drain throughput
        max_new=args.max_new,
        seed=(args.seed, 3),
    )["achieved_rps"]
    out = loadlab.sweep_serve(
        make_engine,
        make_prompts,
        capacity_rps=cap,
        load_fractions=_fractions(args),
        n_requests=args.load_requests,
        max_new=args.max_new,
        seed=args.seed,
        process=args.arrival_process,
    )
    print(
        f"[serve] open-loop sweep: capacity ~{cap:.0f} req/s, "
        f"{args.arrival_process} arrivals, "
        f"{args.load_requests} requests/point"
        + (f", mesh {args.mesh}" if args.mesh else "")
    )
    for p in out["points"]:
        print(
            f"[serve]   {p['load_fraction']:>5.2f}x  "
            f"offered {p['offered_load']:8.1f}/s  "
            f"p50 {p['p50_s'] * 1e3:7.1f}ms  "
            f"p99 {p['p99_s'] * 1e3:7.1f}ms  "
            f"p99.9 {p['p999_s'] * 1e3:7.1f}ms"
        )
    k = out["knee"]
    if k.get("detected"):
        print(
            f"[serve] saturation knee @ {k['knee_rate']:.1f} req/s "
            f"(p99 grows {k['post_knee_growth']:.1f}x past it)"
        )
    slo = out["slo"]
    print(
        f"[serve] SLO {slo['declared']['name']} "
        f"(bound {slo['declared']['bound'] * 1e3:.1f}ms): "
        f"met sub-saturated = {slo['met_sub_saturated']}; "
        f"overload verdict = {out['overload']['verdict']}"
    )
    if args.json:
        print(json.dumps(out, indent=1, default=float))
    return out


def _frontend_sweep(args, make_engine, make_prompts, make_frontend) -> dict:
    """Loopback-socket offered-load sweep through the frontend: measure
    engine capacity closed-loop (or take --admission-rate), then offer
    --load-fractions of it over a real socket with active admission
    control — shed-rate curve, URGENT segment survival, and the overload
    verdict (see `loadlab.sweep_frontend`). Returns the sweep record."""
    from repro_torch.obs import loadlab

    rate = args.admission_rate
    if rate is None:
        rate = loadlab.run_serve_point(
            make_engine,
            make_prompts(max(2 * args.batch, 8)),
            rate_rps=1e5,
            max_new=args.max_new,
            seed=args.seed + 3,
        )["achieved_rps"]
        print(f"[serve] closed-loop capacity ~{rate:.0f} req/s -> "
              f"admission rate")
    out = loadlab.sweep_frontend(
        make_frontend,
        make_prompts,
        admission_rate_rps=rate,
        load_fractions=_fractions(args),
        n_requests=args.load_requests,
        max_new=args.max_new,
        seed=args.seed,
        n_patients=args.patients,
        process=args.arrival_process,
    )
    for p in out["points"]:
        print(
            f"[serve]   {p['load_fraction']:>5.2f}x  "
            f"offered {p['offered_load']:8.1f}/s  "
            f"completed {p['completed']:3d}  "
            f"shed {p['shed_rate']:5.1%}  "
            f"p99 {(p['p99_s'] or float('nan')) * 1e3:7.1f}ms  "
            f"seg-deferred {p['segments']['deferred']}"
        )
    ov = out["overload"]
    print(f"[serve] frontend verdict = {ov['verdict']} "
          f"(accounting_exact={ov['accounting_exact']}, "
          f"urgent_survived={ov['urgent_survived']})")
    to = out.get("transport_overhead")
    if to:
        print(f"[serve] socket - inproc p99: "
              f"{to['socket_minus_inproc_p99_s'] * 1e3:.2f}ms at "
              f"{to['load_fraction']}x")
    if args.json:
        print(json.dumps(out, indent=1, default=float))
    return out


def _sweep_rank(args, device: _device.DeviceLike = None) -> Optional[dict]:
    """`--load-sweep` or `--frontend-sweep` on this rank (every rank of
    the mesh calls it with `--mesh`): the engine (and, for the frontend
    sweep, the stream side's runner) built on every rank; rank 0 runs the
    sweep, its engine's ticks and its frontends sent to the other ranks as
    records (`RecordedEngine`), which replay them (`follow_sweep`) and
    return None."""
    from repro_torch.serve.frontend import (
        Frontend,
        RankRecords,
        RecordedEngine,
        follow_sweep,
    )

    dev = _device.resolve(device)
    _, make_engine, make_prompts = _build_lm_engine(args, dev)
    runner = None
    if args.frontend_sweep:
        from repro_torch.core import compiler, vadetect
        from repro_torch.stream.runner import FleetRunner

        runner = FleetRunner(
            compiler.compile_model(vadetect.init(
                torch.Generator().manual_seed(args.seed), device=dev)),
            device=dev,
        )
    records = None
    if args.mesh:
        n_data, n_model = parse_mesh_spec(args.mesh)
        if _spawn.world_size() != n_data * n_model:
            raise SystemExit(
                f"--{'frontend' if args.frontend_sweep else 'load'}-sweep "
                f"--mesh {args.mesh} runs on exactly {n_data * n_model} "
                f"ranks, not {_spawn.world_size()}")
        records = RankRecords(_spawn.TIMEOUT_S)
    lead = _spawn.rank() == 0

    def make_frontend(fcfg):
        if records is not None and lead:
            records.send({"frontend": fcfg})
        fe = Frontend(engine=make_engine(), n_patients=args.patients,
                      runner=runner, cfg=fcfg,
                      records=records if lead else None)
        fe.warm(args.prompt_len)
        return fe

    if not lead:
        follow_sweep(make_engine(), records, make_frontend)
        return None
    drive = make_engine
    if records is not None:
        drive = lambda: RecordedEngine(make_engine(), records)  # noqa: E731
    try:
        if args.frontend_sweep:
            return _frontend_sweep(args, drive, make_prompts, make_frontend)
        return _load_sweep(args, drive, make_prompts)
    finally:
        if records is not None:
            records.send({"stop": True})


def serve_sweep(args, device: _device.DeviceLike = None) -> dict:
    """`--load-sweep` (and `--frontend-sweep`): on this process, or with
    `--mesh` on ranks spawned for the mesh (or the group that is here);
    returns rank 0's sweep record."""
    if not args.mesh:
        return _sweep_rank(args, device)
    n_data, n_model = parse_mesh_spec(args.mesh)
    dev = "cpu" if _device.resolve(device).type == "cpu" else device
    return _spawn.run(_sweep_rank, n_data * n_model, device=dev,
                      args=(args, dev))


def serve_va(args, device: _device.DeviceLike = None) -> dict:
    from repro_torch.configs import va_cnn
    from repro_torch.core import compiler, vadetect
    from repro_torch.data import iegm
    from repro_torch.serve.va_service import VAService

    dev = _device.resolve(device)
    gen = torch.Generator().manual_seed(args.seed)
    params = vadetect.init(gen, va_cnn.CONFIG, device=dev)
    program = compiler.compile_model(params, va_cnn.CONFIG)
    svc = VAService(program, va_cnn.CONFIG, device=dev)
    batch = iegm.synth_diagnosis_batch(gen, args.patients, device=dev)
    out = svc.diagnose_batch(batch["signal"])
    labels = batch["label"].tolist()
    correct = sum(int(d.is_va) == labels[i] for i, d in enumerate(out))
    rep = svc.report.summary()
    print(f"[serve] va-cnn: {args.patients} diagnoses, "
          f"{correct}/{args.patients} match labels (untrained weights)")
    print(f"[serve] chip model: {rep['latency_us']:.1f}us/inference, "
          f"{rep['effective_GOPS']:.1f} GOPS, "
          f"{rep['avg_power_uW']:.2f} uW")
    return {"diagnoses": out, "correct": correct, "chip": rep}


def main(
    argv: Optional[Sequence[str]] = None, device: _device.DeviceLike = None
) -> dict:
    """Parse `argv` and serve; returns the run's record. `device=None`
    means the CUDA card (raises without one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--quant-bits", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=None,
                    help="enable sampling at this temperature "
                         "(default: greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation for sampling (0 = full "
                         "distribution); needs --temperature")
    ap.add_argument("--patients", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--load-sweep", action="store_true",
                    help="run the open-loop offered-load sweep "
                         "(repro_torch.obs.loadlab) instead of one batch")
    ap.add_argument("--frontend-sweep", action="store_true",
                    help="offered-load sweep through the async "
                         "serving frontend over a loopback socket, "
                         "with knee-aware admission control")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="serve LM requests over the frontend's "
                         "length-prefixed JSON socket transport")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="open-loop socket client against a --listen "
                         "frontend (sends --load-requests at "
                         "--offered-rate)")
    ap.add_argument("--offered-rate", type=float, default=50.0,
                    help="with --connect: offered load in req/s")
    ap.add_argument("--admission-rate", type=float, default=None,
                    help="admission-control rate in req/s for "
                         "--listen/--frontend-sweep (default: "
                         "unbounded for --listen; measured capacity "
                         "for --frontend-sweep)")
    ap.add_argument("--load-fractions",
                    default="0.25,0.5,0.75,1.0,2.0",
                    help="offered load as fractions of measured "
                         "capacity (comma-separated)")
    ap.add_argument("--load-requests", type=int, default=24,
                    help="requests per offered-load point (with "
                         "--connect: requests to offer)")
    ap.add_argument("--arrival-process", default="poisson",
                    choices=["poisson", "trace"],
                    help="interarrival process for --load-sweep, "
                         "--frontend-sweep and --connect")
    ap.add_argument("--json", action="store_true",
                    help="with --load-sweep/--frontend-sweep: dump the "
                         "full sweep record as JSON")
    ap.add_argument("--trace-out", default=None, metavar="PREFIX",
                    help="enable telemetry; on exit write PREFIX.jsonl "
                         "(event log) and PREFIX.json (Chrome/Perfetto "
                         "trace)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="paged KV cache: positions per page (must "
                         "divide every attention window; max_seq is "
                         "rounded up to a multiple)")
    ap.add_argument("--pages-per-device", type=int, default=None,
                    help="with --page-size: physical pages incl. 1 "
                         "scratch (default: the dense pool equivalent, "
                         "batch x span + 1)")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="chunked prefill: split prompts longer than "
                         "this into chunks interleaved with decode ticks")
    ap.add_argument("--mesh", default=None, metavar="D|DxM",
                    help="sharded generate (or, with --listen or a sweep, "
                         "the sharded engine) on a data x model mesh, one "
                         "process a device (e.g. 4, or 2x2)")
    args = ap.parse_args(argv)
    if args.pages_per_device and not args.page_size:
        ap.error("--pages-per-device requires --page-size")
    if args.top_k and args.temperature is None:
        ap.error("--top-k only applies when sampling; pass "
                 "--temperature too (e.g. --temperature 1.0)")
    _device.resolve(device)
    if args.trace_out:
        obs.configure(enabled=True)
    if (args.frontend_sweep or args.listen) and args.arch == "va-cnn":
        ap.error("the serving frontend fronts the LM slot engine; "
                 "for the stream side use repro_torch.launch.stream "
                 "--listen/--connect")
    if args.load_sweep and args.arch == "va-cnn":
        ap.error("--load-sweep drives the LM slot engine; for the fleet "
                 "sweep use repro_torch.launch.stream --load-sweep")
    if args.mesh and args.connect:
        ap.error("--connect is the socket client: the server takes --mesh "
                 "(--listen --mesh)")
    if args.mesh and args.arch == "va-cnn":
        ap.error("--mesh shards the LM; va-cnn serves on one device")
    if args.load_sweep or args.frontend_sweep:
        out = serve_sweep(args, device)
    elif args.listen:
        out = serve_listen(args, device)
    elif args.mesh:
        out = serve_lm_mesh(args, device)
    elif args.connect:
        out = serve_connect(args)
    elif args.arch == "va-cnn":
        out = serve_va(args, device)
    else:
        out = serve_lm(args, device)
    if args.trace_out:
        jsonl, chrome = obs.get().finish(args.trace_out)
        print(f"[obs] trace written: {jsonl} + {chrome}")
    return out


if __name__ == "__main__":
    main()

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
arrivals.

    python -m repro_torch.launch.serve --arch qwen3-8b --listen 127.0.0.1:0 \
        --batch 4 --prompt-len 48 --max-new 16 --page-size 16 \
        --chunk-tokens 16
    python -m repro_torch.launch.serve --arch qwen3-8b --connect HOST:PORT \
        --load-requests 12 --offered-rate 4 --prompt-len 48 --max-new 16

`main(argv, device="cpu")` runs the same paths on the CPU; with no
`device` it needs a card. The reference's mesh, frontend-sweep and
load-sweep flags are refused with the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import _device, configs, obs
from repro_torch.models import api
from repro_torch.serve import engine as E

# the reference's flags whose parts of the system are not ported yet
_NOT_PORTED = {
    "--mesh": "sharded decode, ROADMAP.md queue 1 item 8b",
    "--frontend-sweep": "loadlab.sweep_frontend, ROADMAP.md queue 1 item 9",
    "--load-sweep": "obs.loadlab, ROADMAP.md queue 1 item 9",
    "--load-fractions": "obs.loadlab, ROADMAP.md queue 1 item 9",
    "--json": "obs.loadlab, ROADMAP.md queue 1 item 9",
}
_SWITCHES = ("--load-sweep", "--frontend-sweep", "--json")


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


def serve_lm(args, device: _device.DeviceLike = None) -> dict:
    dev = _device.resolve(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, model, params, prompts = build_lm(args, dev)
    build_s = time.perf_counter() - t0
    if args.quant_bits:
        print(f"[serve] weights quantized to {args.quant_bits} bits")
    sampling = dict(
        greedy=args.temperature is None,
        key=E.fold_in(E.prng_key(args.seed), 1),  # decouple from init/prompts
        # keep an explicit 0.0 (sample_tokens' degenerate-to-greedy case)
        temperature=1.0 if args.temperature is None else args.temperature,
        top_k=args.top_k,
    )
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


def _hostport(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return host or "127.0.0.1", int(port)


def _build_lm_engine(args, device: _device.DeviceLike = None):
    """(cfg, make_engine) of a `--listen` server: the config (full or
    `--reduced`) with max_seq = prompt + max_new + 2, rounded up to a
    multiple of `--page-size`; dense params drawn on `device` from
    `--seed`; and a maker of the slot engine with the paged pool and
    chunked prefill the flags ask for."""
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
    paging = None
    if page:
        per_dev = args.pages_per_device
        if per_dev is None:
            # the dense pool's worth of pages (+1 scratch): paged then
            # never refuses what dense would have seated
            span = validate_page_size(page, model.attn_capacities())
            per_dev = args.batch * span + 1
        paging = PagingConfig(page, per_dev)

    def make_engine():
        return E.Engine(model, params, batch_size=args.batch, paging=paging,
                        chunk_tokens=args.chunk_tokens, device=dev)

    return cfg, make_engine


def serve_listen(args, device: _device.DeviceLike = None) -> dict:
    """Serve LM requests over the frontend's socket transport
    (`serve.frontend`), with admission control at --admission-rate (shed
    with typed rejections past it), until SIGINT. Returns the frontend's
    stats; raises when its driver thread died."""
    import asyncio

    from repro_torch.serve.frontend import Frontend, FrontendConfig

    cfg, make_engine = _build_lm_engine(args, device)
    fe = Frontend(
        engine=make_engine(),
        cfg=FrontendConfig(admission_rate_rps=args.admission_rate),
    )
    fe.warm(args.prompt_len)
    host, port = _hostport(args.listen)

    async def amain() -> None:
        bound = await fe.start(host, port)
        print(f"[serve] frontend listening on {bound[0]}:{bound[1]} "
              f"(admission rate: {args.admission_rate or 'unbounded'})",
              flush=True)
        try:
            while fe.driver_alive():
                await asyncio.sleep(0.2)
        finally:
            await fe.stop()  # raises when the driver died

    try:
        asyncio.run(amain())
    except KeyboardInterrupt:
        print(f"[serve] frontend stopped: {json.dumps(fe.stats())}",
              flush=True)
    stats = fe.stats()
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab, "stats": stats}


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
                    help="admission-control rate in req/s for --listen "
                         "(default: unbounded)")
    ap.add_argument("--load-requests", type=int, default=24,
                    help="with --connect: requests to offer")
    ap.add_argument("--arrival-process", default="poisson",
                    choices=["poisson", "trace"],
                    help="with --connect: interarrival process")
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
    for flag, what in _NOT_PORTED.items():
        kw = ({"action": "store_true"} if flag in _SWITCHES
              else {"default": None})
        ap.add_argument(flag, help=f"not ported yet ({what})", **kw)
    args = ap.parse_args(argv)
    for flag, what in _NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) not in (None, False):
            ap.error(f"{flag} is not ported yet ({what})")
    if args.pages_per_device and not args.page_size:
        ap.error("--pages-per-device requires --page-size")
    if args.top_k and args.temperature is None:
        ap.error("--top-k only applies when sampling; pass "
                 "--temperature too (e.g. --temperature 1.0)")
    _device.resolve(device)
    if args.trace_out:
        obs.configure(enabled=True)
    if args.listen and args.arch == "va-cnn":
        ap.error("the serving frontend fronts the LM slot engine; "
                 "for the stream side use repro_torch.launch.stream "
                 "--listen/--connect")
    if args.listen:
        out = serve_listen(args, device)
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

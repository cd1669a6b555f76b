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

`main(argv, device="cpu")` runs the same path on the CPU; with no
`device` it needs a card. The reference's mesh, frontend, load-sweep,
paging and chunked-prefill flags are refused with the ROADMAP.md item
that ports them.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch import _device, configs, obs
from repro_torch.models import api
from repro_torch.serve import engine as E

# the reference's flags whose parts of the system are not ported yet
_NOT_PORTED = {
    "--mesh": "sharded decode, ROADMAP.md queue 1 item 8",
    "--listen": "the serving frontend, ROADMAP.md queue 1 item 7",
    "--connect": "the serving frontend, ROADMAP.md queue 1 item 7",
    "--frontend-sweep": "the serving frontend, ROADMAP.md queue 1 item 7",
    "--admission-rate": "the serving frontend, ROADMAP.md queue 1 item 7",
    "--offered-rate": "the serving frontend, ROADMAP.md queue 1 item 7",
    "--load-sweep": "obs.loadlab, ROADMAP.md queue 1 item 9",
    "--load-fractions": "obs.loadlab, ROADMAP.md queue 1 item 9",
    "--load-requests": "obs.loadlab, ROADMAP.md queue 1 item 9",
    "--arrival-process": "obs.loadlab, ROADMAP.md queue 1 item 9",
    "--json": "obs.loadlab, ROADMAP.md queue 1 item 9",
    "--page-size": "the paged cache, ROADMAP.md queue 1 item 7",
    "--pages-per-device": "the paged cache, ROADMAP.md queue 1 item 7",
    "--chunk-tokens": "chunked prefill, ROADMAP.md queue 1 item 7",
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
    ap.add_argument("--trace-out", default=None, metavar="PREFIX",
                    help="enable telemetry; on exit write PREFIX.jsonl "
                         "(event log) and PREFIX.json (Chrome/Perfetto "
                         "trace)")
    for flag, what in _NOT_PORTED.items():
        kw = ({"action": "store_true"} if flag in _SWITCHES
              else {"default": None})
        ap.add_argument(flag, help=f"not ported yet ({what})", **kw)
    args = ap.parse_args(argv)
    for flag, what in _NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) not in (None, False):
            ap.error(f"{flag} is not ported yet ({what})")
    if args.top_k and args.temperature is None:
        ap.error("--top-k only applies when sampling; pass "
                 "--temperature too (e.g. --temperature 1.0)")
    _device.resolve(device)
    if args.trace_out:
        obs.configure(enabled=True)
    if args.arch == "va-cnn":
        out = serve_va(args, device)
    else:
        out = serve_lm(args, device)
    if args.trace_out:
        jsonl, chrome = obs.get().finish(args.trace_out)
        print(f"[obs] trace written: {jsonl} + {chrome}")
    return out


if __name__ == "__main__":
    main()

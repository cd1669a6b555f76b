"""Batched LM serving demo: batched-prefill admission + quantized decode,
on the card (port of `examples/serve_lm.py`).

    python -m repro_torch.examples.serve_lm [--arch qwen3-8b] [--smoke]

Submits a burst of variable-length requests to the slot engine in one
call: admission groups them by prompt length, runs one batched
`model.prefill` per group, and scatter-seats the resulting cache rows
into the pool (`repro_torch.serve.seating`) — O(prompt) work per
request, independent of the pool size; the demo prints the measured
admission work next to what pool-replay admission would have cost. Then
repeats with int8/int4 weight-only quantization (the packed projections
run the hand-written `quant_matmul` kernel on the card) and reports the
token agreement between precisions, and draws a sampled batch twice.
The reference's mesh-sharded engine block is not ported (ROADMAP.md
queue 1 item 8b).

`--smoke` shrinks the burst and asserts the demo's claims instead of
just printing them. `main(argv, device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch import _device, configs, obs
from repro_torch.models import api
from repro_torch.serve import engine as E


def submit_burst(eng, reqs):
    """Admit a whole burst in one call: submit everything, then tick —
    the engine batches the admission prefills per prompt length."""
    for r in reqs:
        eng.submit(r)
    eng.run()


def _randint(seed: int, shape: tuple, high: int) -> torch.Tensor:
    """Seeded token ids, drawn on the CPU (the same on every device)."""
    return torch.randint(0, high, shape,
                         generator=torch.Generator().manual_seed(seed))


def main(
    argv: Optional[Sequence[str]] = None, device: _device.DeviceLike = None
) -> dict:
    """Run the demo; returns the burst's outputs, the admission counts,
    the quantized agreements and the sampled tokens. `device=None` means
    the CUDA card (raises without one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="small burst + assertions")
    ap.add_argument("--trace-out", default=None, metavar="PREFIX",
                    help="enable telemetry; write PREFIX.jsonl + "
                         "PREFIX.json (Chrome trace) on exit")
    args = ap.parse_args(argv)
    dev = _device.resolve(device)
    if args.smoke:
        args.requests, args.slots, args.max_new = 4, 2, 4
    if args.trace_out:
        # before engine construction so its cells register with the probe
        obs.configure(enabled=True)

    cfg = configs.reduced(args.arch)
    model = api.build_model(cfg, tp=1, max_seq=96)
    params = model.init(0, device=dev)

    def make_requests():
        # pairwise-repeated lengths (4, 4, 7, 7, ...) so co-admitted
        # requests share batched prefill cells
        return [
            E.Request(
                uid=i,
                prompt=_randint(i, (4 + (i // 2 % 2) * 3,), cfg.vocab),
                max_new=args.max_new,
            )
            for i in range(args.requests)
        ]

    # --- slot engine: one burst, batched admission ----------------------
    eng = E.Engine(model, params, batch_size=args.slots, device=dev)
    reqs = make_requests()
    submit_burst(eng, reqs)
    replay_cost = sum(r.prompt.shape[0] for r in reqs) * args.slots
    print(f"engine: {args.requests} requests over {args.slots} slots")
    for r in reqs:
        print(f"  req {r.uid} (prompt {r.prompt.shape[0]:2d} tok): "
              f"{r.output}")
    print(
        f"admission: {args.requests} requests seated through "
        f"{eng.admission_prefills} batched prefill cells, "
        f"{eng.admission_rowsteps} row-tokens of work "
        f"(pool-replay admission would have spent {replay_cost})"
    )
    if args.smoke:
        assert all(r.done for r in reqs)
        # batched: fewer prefill cells than requests, less work than
        # stepping every prompt token through the whole pool
        assert eng.admission_prefills < args.requests
        assert eng.admission_rowsteps < replay_cost

    # --- quantized serving comparison -----------------------------------
    prompts = _randint(42, (4, 12), cfg.vocab)
    base = E.generate(model, params, prompts, max_new=args.max_new,
                      device=dev)
    agreement = {}
    for bits in (8, 4) if not args.smoke else (8,):
        qp = E.quantize_for_serving(params, bits)
        out = E.generate(model, qp, prompts, max_new=args.max_new,
                         device=dev)
        agreement[bits] = float((out == base).float().mean())
        print(f"int{bits} weight-only decode: token agreement vs "
              f"{cfg.dtype} = {agreement[bits]:.2f}")

    # --- sampling: per-request keys -------------------------------------
    def sample():
        return E.generate(
            model, params, prompts, max_new=args.max_new, greedy=False,
            key=E.prng_key(7), temperature=0.8, top_k=20, device=dev,
        )

    sampled, again = sample(), sample()
    assert torch.equal(sampled, again)
    print(f"sampled (T=0.8, top-k=20, reproducible): "
          f"{sampled[0].tolist()}")

    if args.trace_out:
        tel = obs.get()
        jsonl, chrome = tel.finish(args.trace_out)
        snap = tel.registry.snapshot()
        # the telemetry mirrors of the engine's admission counters must
        # agree with the engine's own accounting
        assert snap["counters"].get("serve.admission_prefills", 0) >= \
            eng.admission_prefills
        print(f"trace written: {jsonl} + {chrome} "
              f"(signatures: {tel.probe.cache_sizes()})")
    return {
        "outputs": [r.output for r in reqs],
        "admission_prefills": eng.admission_prefills,
        "admission_rowsteps": eng.admission_rowsteps,
        "replay_cost": replay_cost,
        "agreement": agreement,
        "sampled": sampled.tolist(),
    }


if __name__ == "__main__":
    main()

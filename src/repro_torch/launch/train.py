"""Training launcher: --arch <id> [--reduced] on the card (port of
`repro.launch.train`).

    python -m repro_torch.launch.train --arch recurrentgemma-2b --steps 4
    python -m repro_torch.launch.train --arch qwen3-8b --reduced \\
        --steps 50 --batch 8 --seq 64 --ckpt /tmp/ck
    python -m repro_torch.launch.train --arch va-cnn --steps 300

Without `--reduced` the LM trains the architecture's full `CONFIG` from
random weights drawn on the card from `--seed`, in the config's compute
dtype over float32 masters, with AdamW (warmup-cosine schedule, weight
decay 0.01), global-norm clipping at 1.0, `--grad-accum` micro-batches
and the config's block remat. The step is donated
(`trainer.make_train_step(..., donate=True)`: the update is written into
the state in place), as the reference donates its jitted step: AdamW's
float32 state is 16 bytes a parameter, so recurrentgemma-2b's 3.55 B
parameters hold 56.8 GB, which fits one 80 GB card only without a second
copy. `--spe-bits` / `--spe-sparse` apply the paper's co-design QAT
(16:8 prune-STE and fake-quant) to every projection. The data is the
synthetic `data.lm.TokenStream`; whisper-family configs also get frames
drawn from a generator keyed by the step. `--arch va-cnn` trains the
paper's VA detector on the IEGM stream instead.

`--multi-pod PxD[xM]` switches to compressed multi-pod data parallelism
(`trainer.make_multipod_train_step`) over a ("pod", "data", "model")
`DeviceMesh`, one rank a pod: the pod axis reduces gradients through
`dist.compression` — `--scheme gather` (default; (8/n)x egress, best
below 8 pods) or `--scheme two_stage` (n-independent ~4x),
`--no-compress` for the f32 ablation baseline. The error-feedback
buffers ride in the checkpointed state, so kill-and-resume reproduces
the uninterrupted run bit for bit. The ranks come from
`launch._spawn.run`: spawned here over gloo with `device="cpu"`, NCCL on
the cards (one rank a card), or `torchrun`'s. Every rank draws the same
params and takes rank 0's by broadcast; only rank 0 logs, prints and
writes checkpoints. In-pod axes (D or M > 1: FSDP and TP) are refused,
naming ROADMAP.md queue 1 item 8b.

    python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --multi-pod 1x1 --scheme gather --steps 4

`main(argv, device="cpu")` runs the same paths on the CPU (multi-pod:
P gloo ranks); with no `device` it needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import math
from typing import Optional, Sequence

import torch

import torch.distributed as dist

from repro_torch import _device, configs, obs
from repro_torch._tree import leaves, tree_map
from repro_torch.data import iegm, lm
from repro_torch.data.iegm import _stream_seed
from repro_torch.launch import _spawn
from repro_torch.launch.mesh import make_multipod_mesh, parse_multipod_spec
from repro_torch.models import api
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.train import fault, trainer

FRAMES_SEED = 7  # the whisper frames' stream, keyed (7, 0, step)


def _lm_cfg(args):
    cfg = configs.reduced(args.arch) if args.reduced else configs.get(
        args.arch
    )
    if args.spe_bits or args.spe_sparse:
        cfg = dataclasses.replace(
            cfg, spe_bits=args.spe_bits, spe_sparse=args.spe_sparse
        )
    return cfg


def lm_batch_at(stream: lm.TokenStream, cfg, batch: int):
    """step -> batch, adding the deterministic encoder frames (B, enc_seq,
    d_model) the whisper-family loss consumes, drawn on the stream's
    device from a generator keyed by the step."""
    def batch_at(step):
        b = stream.batch_at(step)
        if cfg.is_enc_dec:
            gen = torch.Generator(device=stream.device)
            gen.manual_seed(_stream_seed(FRAMES_SEED, 0, step))
            b["frames"] = torch.randn(
                (batch, cfg.enc_seq, cfg.d_model), generator=gen,
                device=stream.device,
            )
        return b

    return batch_at


def train_lm(args, device: _device.DeviceLike = None) -> dict:
    """Returns {"history", "state", "step_fn", "batch_at"}: the metric
    history, the final (donated) state, the tracked step function and the
    batch source, so a caller can take further steps."""
    dev = _device.resolve(device)
    cfg = _lm_cfg(args)
    model = api.build_model(cfg, tp=1, max_seq=args.seq)
    params = model.init(args.seed, device=dev)
    n_params = sum(p.numel() for p in leaves(params))
    logging.info("arch=%s params=%.3fM", cfg.name, n_params / 1e6)

    opt = adamw(
        linear_warmup_cosine(args.lr, args.warmup, args.steps),
        weight_decay=0.01,
    )
    state = trainer.init_state(params, opt, device=dev)
    del params
    step_fn = obs.get().probe.track("train.step", trainer.make_train_step(
        model.loss, opt, clip_norm=1.0, n_micro=args.grad_accum, donate=True,
    ))
    stream = lm.TokenStream(
        batch=args.batch, seq_len=args.seq, vocab=cfg.vocab, seed=args.seed,
        device=dev,
    )
    batch_at = lm_batch_at(stream, cfg, args.batch)
    state, history = fault.run_training(
        step_fn, state, batch_at,
        num_steps=args.steps,
        ckpt_dir=args.ckpt,
        ckpt_every=args.ckpt_every,
        watchdog=fault.StragglerWatchdog(),
        log_every=args.log_every,
    )
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"[train] {cfg.name}: loss {first:.4f} -> {last:.4f} "
          f"({len(history)} steps)")
    return {"history": history, "state": state, "step_fn": step_fn,
            "batch_at": batch_at}


def train_lm_multipod(args, device: _device.DeviceLike = None):
    """Compressed multi-pod DP on this rank of the process group (every
    rank of the mesh calls it): the pod axis's quantized reduction,
    checkpoint-restartable with the error buffers. Returns
    {"history", "state", "step_fn", "batch_at"} as `train_lm` does, or
    None on a rank outside the mesh."""
    dev = _device.resolve(device)
    cfg = _lm_cfg(args)
    mesh = make_multipod_mesh(args.multi_pod, dev)
    if mesh.get_coordinate() is None:
        return None
    n_pod = mesh.size(0)
    if args.batch % n_pod:
        raise SystemExit(
            f"--batch {args.batch} must divide by {n_pod} pods"
        )
    compress = not args.no_compress
    lead = _spawn.rank() == 0
    if args.trace_out:
        obs.configure(enabled=True)
    model = api.build_model(cfg, tp=1, max_seq=args.seq)
    params = model.init(args.seed, device=dev)
    pods = mesh.get_group("pod")
    for p in leaves(params):  # every pod starts from pod 0's draw
        dist.broadcast(p, src=dist.get_global_rank(pods, 0), group=pods)
    if lead:
        logging.info(
            "arch=%s params=%.3fM mesh=%s scheme=%s compress=%s",
            cfg.name, sum(p.numel() for p in leaves(params)) / 1e6,
            dict(zip(mesh.mesh_dim_names, mesh.shape)), args.scheme,
            compress,
        )
    opt = adamw(
        linear_warmup_cosine(args.lr, args.warmup, args.steps),
        weight_decay=0.01,
    )
    state = trainer.init_state(params, opt, device=dev)
    del params
    state["err"] = trainer.init_dp_err(
        state["params"], mesh, scheme=args.scheme, compress=compress
    )
    step, s_shard = trainer.make_multipod_train_step(
        model.loss, opt, cfg, mesh, state, scheme=args.scheme,
        compress=compress, clip_norm=1.0, n_micro=args.grad_accum,
    )
    step_fn = obs.get().probe.track("train.step", step)
    stream = lm.TokenStream(
        batch=args.batch, seq_len=args.seq, vocab=cfg.vocab, seed=args.seed,
        device=dev,
    )
    batch_at = lm_batch_at(stream, cfg, args.batch)
    state, history = fault.run_training(
        step_fn, state, batch_at,
        num_steps=args.steps,
        ckpt_dir=args.ckpt,
        ckpt_every=args.ckpt_every,
        watchdog=fault.StragglerWatchdog() if lead else None,
        log_every=args.log_every if lead else 0,
        restore_shardings=s_shard,
    )
    if lead:
        first, last = history[0]["loss"], history[-1]["loss"]
        print(
            f"[train] {cfg.name} multi-pod {args.multi_pod} "
            f"scheme={args.scheme if compress else 'f32'}: "
            f"loss {first:.4f} -> {last:.4f} ({len(history)} steps)"
        )
        if args.trace_out:
            jsonl, chrome = obs.get().finish(args.trace_out)
            print(f"[obs] trace written: {jsonl} + {chrome}")
    return {"history": history, "state": state, "step_fn": step_fn,
            "batch_at": batch_at}


def _multipod_record(args, device) -> dict | None:
    """`train_lm_multipod` on a spawned rank: the history and the state
    on the host (what crosses back to the caller)."""
    out = train_lm_multipod(args, device)
    if out is None:
        return None
    return {"history": out["history"],
            "state": tree_map(lambda x: x.cpu(), out["state"])}


def _run_multipod(args, device) -> dict:
    if args.arch == "va-cnn":
        raise SystemExit(
            "--multi-pod currently drives the LM trainer; va-cnn "
            "fits on one pod (use the plain path)"
        )
    world = math.prod(parse_multipod_spec(args.multi_pod))
    fn = _multipod_record if _spawn.spawns(world) else train_lm_multipod
    dev = "cpu" if _device.resolve(device).type == "cpu" else device
    return _spawn.run(fn, world, device=dev, args=(args, dev))


def train_va(args, device: _device.DeviceLike = None) -> dict:
    from repro_torch.configs import va_cnn
    from repro_torch.core import vadetect

    dev = _device.resolve(device)
    cfg = va_cnn.CONFIG
    params = vadetect.init(torch.Generator().manual_seed(args.seed), cfg,
                           device=dev)
    opt = adamw(linear_warmup_cosine(args.lr, args.warmup, args.steps))
    state = trainer.init_state(params, opt, device=dev)
    step_fn = obs.get().probe.track("train.step", trainer.make_train_step(
        lambda p, b: vadetect.loss_fn(p, b, cfg), opt, clip_norm=1.0,
        donate=True,
    ))
    stream = iegm.IEGMStream(batch=args.batch, seed=args.seed, device=dev)
    state, history = fault.run_training(
        step_fn, state, stream.batch_at,
        num_steps=args.steps, ckpt_dir=args.ckpt,
        ckpt_every=args.ckpt_every, log_every=args.log_every,
    )
    accs = [h["accuracy"] for h in history[-20:]]
    print(f"[train] va-cnn: loss {history[0]['loss']:.4f} -> "
          f"{history[-1]['loss']:.4f}; acc(last20) "
          f"{sum(accs)/len(accs):.4f}")
    return {"history": history, "state": state}


def main(
    argv: Optional[Sequence[str]] = None, device: _device.DeviceLike = None
) -> dict:
    """Parse `argv` and train; returns the run's record (`train_lm`'s,
    `train_lm_multipod`'s — only "history" and "state" where its ranks
    were spawned — or `train_va`'s). `device=None` means the CUDA card
    (raises without one)."""
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spe-bits", type=int, default=None)
    ap.add_argument("--spe-sparse", action="store_true")
    ap.add_argument(
        "--trace-out", default=None, metavar="PREFIX",
        help="enable telemetry; on exit write PREFIX.jsonl (event log) "
             "and PREFIX.json (Chrome/Perfetto trace)",
    )
    ap.add_argument(
        "--multi-pod", type=str, default=None, metavar="PxD[xM]",
        help="compressed multi-pod DP over a (pod, data, model) mesh, "
             "e.g. 2x1 (one rank a pod; D = M = 1 until ROADMAP.md item 8b)",
    )
    ap.add_argument(
        "--scheme", choices=("gather", "two_stage"), default="gather",
        help="cross-pod wire layout: gather=(8/n)x egress (n<8 pods), "
             "two_stage=n-independent ~4x (n>=8)",
    )
    ap.add_argument(
        "--no-compress", action="store_true",
        help="f32 cross-pod reduction (ablation baseline)",
    )
    args = ap.parse_args(argv)
    if args.multi_pod:
        _, n_data, n_model = parse_multipod_spec(args.multi_pod)
        if n_data * n_model > 1:
            ap.error(
                f"--multi-pod {args.multi_pod}: in-pod data x model = "
                f"{n_data * n_model}; placing parameters over 'data' and "
                f"'model' (FSDP, TP) is not ported yet (ROADMAP.md queue 1 "
                f"item 8b): use PxD with D = 1"
            )
    _device.resolve(device)
    if args.multi_pod:
        return _run_multipod(args, device)
    if args.trace_out:
        # before the step is built, so it registers with the probe
        obs.configure(enabled=True)
    if args.arch == "va-cnn":
        out = train_va(args, device)
    else:
        out = train_lm(args, device)
    if args.trace_out:
        jsonl, chrome = obs.get().finish(args.trace_out)
        print(f"[obs] trace written: {jsonl} + {chrome} "
              f"(cells: {obs.get().probe.cache_sizes()})")
    return out


if __name__ == "__main__":
    main()

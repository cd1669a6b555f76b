"""LM training driver over the assigned-architecture substrate, on the
card (port of `examples/train_lm.py`).

    # a reduced config, a few hundred steps:
    python -m repro_torch.examples.train_lm --arch qwen3-8b --steps 200

    # the ~100M-parameter run (d_model 768, 8 layers, vocab 32768):
    python -m repro_torch.examples.train_lm --hundred-m --steps 300

Uses the same trainer, checkpoint and fault stack as
`repro_torch.launch.train`, with the step donated (updated in place); the
paper's technique applies through --spe-bits/--spe-sparse (QAT on every
projection). `main(argv, device="cpu")` runs the same path on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import tempfile
from typing import Optional, Sequence

from repro_torch import _device, configs, optim
from repro_torch._tree import leaves
from repro_torch.configs.base import ArchConfig
from repro_torch.data import lm
from repro_torch.launch.train import lm_batch_at
from repro_torch.models import api
from repro_torch.train import fault, trainer

HUNDRED_M = ArchConfig(
    name="lm-100m",
    family="dense",
    n_layers=8,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=3072,
    vocab=32768,
    qk_norm=True,
)  # ~100M params


def main(
    argv: Optional[Sequence[str]] = None, device: _device.DeviceLike = None
) -> dict:
    """Train; returns {"history", "state", "ckpt_dir", "uniform"} (the
    uniform baseline's loss, log(vocab)). `device=None` means the CUDA
    card (raises without one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--spe-bits", type=int, default=None)
    ap.add_argument("--spe-sparse", action="store_true")
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args(argv)
    dev = _device.resolve(device)

    cfg = HUNDRED_M if args.hundred_m else configs.reduced(args.arch)
    if args.spe_bits or args.spe_sparse:
        cfg = dataclasses.replace(
            cfg, spe_bits=args.spe_bits, spe_sparse=args.spe_sparse
        )
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="lm_ckpt_")

    model = api.build_model(cfg, tp=1, max_seq=args.seq)
    params = model.init(0, device=dev)
    n = sum(p.numel() for p in leaves(params))
    print(f"arch={cfg.name} params={n/1e6:.1f}M "
          f"spe_bits={cfg.spe_bits} spe_sparse={cfg.spe_sparse}")

    opt = optim.adamw(
        optim.linear_warmup_cosine(args.lr, 20, args.steps),
        weight_decay=0.01,
    )
    state = trainer.init_state(params, opt, device=dev)
    del params
    step = trainer.make_train_step(model.loss, opt, clip_norm=1.0,
                                   donate=True)
    stream = lm.TokenStream(batch=args.batch, seq_len=args.seq,
                            vocab=cfg.vocab, seed=0, device=dev)
    state, history = fault.run_training(
        step, state, lm_batch_at(stream, cfg, args.batch),
        num_steps=args.steps, ckpt_dir=ckpt_dir, ckpt_every=100,
        log_every=25,
    )
    uniform = math.log(cfg.vocab)
    print(f"loss: {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f} "
          f"(uniform baseline {uniform:.2f}); ckpts in {ckpt_dir}")
    return {"history": history, "state": state, "ckpt_dir": ckpt_dir,
            "uniform": uniform}


if __name__ == "__main__":
    main()

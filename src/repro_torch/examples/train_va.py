"""End-to-end training driver for the paper's VA detector, on the card
(port of `examples/train_va.py`).

    PYTHONPATH=src python -m repro_torch.examples.train_va [--steps 300]

Full production path: deterministic host-sharded data -> co-design QAT
(prune-STE + fake-quant) -> atomic checkpoints (keep-3) -> straggler
watchdog -> compile to the accelerator format -> held-out evaluation
(per-segment accuracy, post-vote diagnostic accuracy, precision/recall)
next to the paper's reported numbers. A second call on the same
`--ckpt` directory resumes from its newest checkpoint.

`main(argv, device="cpu")` runs the same path on the CPU.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch import _device, optim
from repro_torch.configs import va_cnn
from repro_torch.core import compiler, vadetect
from repro_torch.data import iegm
from repro_torch.serve.va_service import VAService
from repro_torch.train import fault, trainer


def evaluate(
    program: compiler.AcceleratorProgram,
    cfg: vadetect.VAConfig,
    *,
    patients: int = 256,
    seed: int = 123,
    device: _device.DeviceLike = None,
) -> tuple[float, float, float, float]:
    """(segment accuracy, diagnostic accuracy, precision, recall) of the
    compiled program on `patients` synthetic diagnoses drawn from `seed`,
    through `VAService` on the reference path."""
    dev = _device.resolve(device)
    svc = VAService(program, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = iegm.synth_diagnosis_batch(gen, patients, device=dev)
    out = svc.diagnose_batch(batch["signal"])
    labels = batch["label"].tolist()
    preds = [int(d.is_va) for d in out]
    seg_preds = torch.tensor([d.segment_preds for d in out])
    seg_labels = torch.tensor(labels)[:, None].expand(-1, 6)
    seg_acc = float((seg_preds == seg_labels).to(torch.float32).mean())
    tp = sum(p and l for p, l in zip(preds, labels))
    fp = sum(p and not l for p, l in zip(preds, labels))
    fn = sum((not p) and l for p, l in zip(preds, labels))
    acc = sum(p == l for p, l in zip(preds, labels)) / len(labels)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return seg_acc, acc, prec, rec


def main(
    argv: Optional[Sequence[str]] = None, device: _device.DeviceLike = None
) -> dict:
    """Train, checkpoint, compile and evaluate; returns the history, the
    watchdog's flagged steps, the four accuracies and the chip model's
    summary. `device=None` means the CUDA card (raises without one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--ckpt", type=str, default=None)
    args = ap.parse_args(argv)
    dev = _device.resolve(device)
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="va_ckpt_")

    cfg = va_cnn.CONFIG
    params = vadetect.init(torch.Generator().manual_seed(0), cfg, device=dev)
    print(f"model: {vadetect.param_count(params)} params, "
          f"8 conv layers, 16:8 sparsity, 8-bit")

    opt = optim.adamw(
        optim.linear_warmup_cosine(3e-3, 30, args.steps), weight_decay=1e-4
    )
    state = trainer.init_state(params, opt, device=dev)
    step = trainer.make_train_step(
        lambda p, b: vadetect.loss_fn(p, b, cfg), opt, clip_norm=1.0
    )
    stream = iegm.IEGMStream(batch=args.batch, seed=0, device=dev)
    watchdog = fault.StragglerWatchdog()
    state, history = fault.run_training(
        step, state, stream.batch_at,
        num_steps=args.steps, ckpt_dir=ckpt_dir, ckpt_every=100,
        watchdog=watchdog, log_every=50,
    )
    print(f"training done: loss {history[0]['loss']:.4f} -> "
          f"{history[-1]['loss']:.4f}; checkpoints in {ckpt_dir}; "
          f"stragglers flagged: {len(watchdog.flagged)}")

    program = compiler.compile_model(state["params"], cfg)
    seg_acc, acc, prec, rec = evaluate(program, cfg, device=dev)
    print("\n              segment-acc  diagnostic-acc  precision  recall")
    print(f"this run         {seg_acc:7.4f}        {acc:7.4f}    "
          f"{prec:7.4f}  {rec:7.4f}   (synthetic IEGM)")
    print("paper            0.9235         0.9995     0.9988   0.9984"
          "   (SingularMedical silicon)")
    s = program.report.summary()
    print(f"\nchip model: {s['latency_us']:.1f} us | "
          f"{s['effective_GOPS']:.0f} GOPS | {s['avg_power_uW']:.2f} uW")
    return {
        "ckpt_dir": ckpt_dir,
        "history": history,
        "flagged": list(watchdog.flagged),
        "segment_acc": seg_acc,
        "diagnostic_acc": acc,
        "precision": prec,
        "recall": rec,
        "chip": s,
    }


if __name__ == "__main__":
    main()

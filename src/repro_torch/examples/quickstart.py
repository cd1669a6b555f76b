"""Quickstart: the paper's pipeline end to end, on the card (port of
`examples/quickstart.py`).

    PYTHONPATH=src python -m repro_torch.examples.quickstart

Trains the 8-layer 1-D FCN VA detector under the chip's constraints (50%
balanced sparsity + 8-bit weights, co-design QAT), freezes it into the
accelerator program format, runs chip-format inference with 6-segment
voting on the kernel path (the hand-written `nm_spmm` on the card), and
prints the modelled silicon numbers.

`run(device="cpu", ...)` runs the same pipeline on the CPU, with the
kernels' plain versions.
"""

from __future__ import annotations

import torch

from repro_torch import _device, optim
from repro_torch.configs import va_cnn
from repro_torch.core import compiler, vadetect
from repro_torch.data import iegm
from repro_torch.serve.va_service import VAService
from repro_torch.train import trainer


def run(
    device: _device.DeviceLike = None,
    steps: int = 200,
    batch: int = 64,
    seed: int = 0,
    patients: int = 16,
) -> dict:
    """The four steps of the reference quickstart; returns the per-step
    losses and accuracies, the compiled program's size and compression,
    the diagnostic accuracy and the chip model's summary. `device=None`
    means the CUDA card (raises without one)."""
    dev = _device.resolve(device)
    cfg = va_cnn.CONFIG  # paper operating point: 16:8 sparsity, 8-bit

    # 1. co-design QAT training on synthetic IEGM (512 pts @ 250 Hz,
    #    15-55 Hz band-passed — the paper's acquisition spec)
    params = vadetect.init(torch.Generator().manual_seed(seed), cfg, device=dev)
    opt = optim.adam(3e-3)
    state = trainer.init_state(params, opt, device=dev)
    step = trainer.make_train_step(
        lambda p, b: vadetect.loss_fn(p, b, cfg), opt, clip_norm=1.0
    )
    stream = iegm.IEGMStream(batch=batch, seed=seed, device=dev)
    losses, accs = [], []
    for i in range(steps):
        state, metrics = step(state, stream.batch_at(i))
        losses.append(metrics["loss"])
        accs.append(metrics["accuracy"])
        if i % 50 == 0:
            print(f"step {i:4d}  loss={float(metrics['loss']):.4f}  "
                  f"acc={float(metrics['accuracy']):.4f}", flush=True)

    # 2. compiler: freeze into the chip's compressed format
    program = compiler.compile_model(state["params"], cfg)
    kib = program.weight_hbm_bytes() / 1024
    ratio = program.compression_ratio()
    print(f"\ncompiled: {kib:.1f} KiB on-chip ({ratio:.1f}x vs dense f32)")

    # 3. chip-format inference + 6-segment voting diagnosis
    svc = VAService(program, cfg, path="kernel", device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    diag = iegm.synth_diagnosis_batch(gen, patients, device=dev)
    diagnoses = svc.diagnose_batch(diag["signal"])
    labels = diag["label"].tolist()
    correct = sum(int(d.is_va) == labels[i] for i, d in enumerate(diagnoses))
    print(f"diagnostic accuracy (synthetic): {correct}/{patients}")

    # 4. the silicon numbers, from the analytic chip model
    s = svc.report.summary()
    print(f"chip model: {s['latency_us']:.1f} us/inference, "
          f"{s['effective_GOPS']:.0f} GOPS, {s['avg_power_uW']:.2f} uW, "
          f"{s['power_density_uW_mm2']:.2f} uW/mm^2")
    print("paper     : 35.0 us, 150 GOPS, 10.60 uW, 0.57 uW/mm^2")
    return {
        "device": str(dev),
        "losses": torch.stack(losses).tolist() if losses else [],
        "accuracies": torch.stack(accs).tolist() if accs else [],
        "compiled_kib": kib,
        "compression": ratio,
        "correct": correct,
        "patients": patients,
        "chip": s,
    }


def main() -> None:
    run()


if __name__ == "__main__":
    main()

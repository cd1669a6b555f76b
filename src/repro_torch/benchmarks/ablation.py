"""Sparsity x bit-width ablation (the compression recipe's accuracy cost),
on the card (port of `benchmarks/ablation.py`).

    python -m repro_torch.benchmarks.ablation

Trains the VA detector under each (sparsity, bits) operating point for a
short budget on synthetic IEGM and reports per-segment accuracy + model
storage. Reproduces the paper's design decision: 50% balanced sparsity +
8-bit costs almost nothing vs the dense float baseline; the CMUL's
sub-byte modes trade accuracy for energy.

The µs column is the wall time of the training loop per step. The loop
reads each step's accuracy back to the host, as the reference does, so
it includes the card's work. The batches come from the port's
`IEGMStream` (torch cannot reproduce `jax.random`), so the accuracies
match the reference's in kind, not in value; the storage columns are the
compiler's and equal the reference's on the same parameters.
"""

from __future__ import annotations

import time

import torch

from repro_torch import _device, optim
from repro_torch.core import compiler, vadetect
from repro_torch.core.spe import SPEConfig
from repro_torch.data import iegm
from repro_torch.train import trainer

POINTS = [
    ("dense_f32", None),
    ("sparse50_8b", SPEConfig(bits=8, sparse=True, quantized=True)),
    ("sparse50_4b", SPEConfig(bits=4, sparse=True, quantized=True)),
    ("dense_8b", SPEConfig(bits=8, sparse=False, quantized=True)),
    ("sparse50_2b", SPEConfig(bits=2, sparse=True, quantized=True)),
]

STEPS = 120
BATCH = 64


def train_point(
    spe: SPEConfig | None, *, steps: int = STEPS,
    device: _device.DeviceLike = None,
) -> dict:
    """Train `VAConfig(spe=spe)` from seed 0 for `steps` adam steps at
    BATCH. Returns {"cfg", "params", "us_per_step", "losses",
    "accuracies", "weights_kb", "compress"}, the last two the trained
    params' `storage`."""
    dev = _device.resolve(device)
    cfg = vadetect.VAConfig(spe=spe)
    params = vadetect.init(torch.Generator().manual_seed(0), cfg, device=dev)
    opt = optim.adam(3e-3)
    state = trainer.init_state(params, opt, device=dev)
    step = trainer.make_train_step(
        lambda p, b: vadetect.loss_fn(p, b, cfg), opt, clip_norm=1.0
    )
    stream = iegm.IEGMStream(batch=BATCH, seed=0, device=dev)
    t0 = time.perf_counter()
    losses, accs = [], []
    for i in range(steps):
        state, m = step(state, stream.batch_at(i))
        losses.append(m["loss"])
        accs.append(float(m["accuracy"]))
    us = (time.perf_counter() - t0) / steps * 1e6
    kb, ratio = storage(state["params"], cfg)
    return {"cfg": cfg, "params": state["params"], "us_per_step": us,
            "losses": [float(l) for l in losses], "accuracies": accs,
            "weights_kb": kb, "compress": ratio}


def storage(params: dict, cfg: vadetect.VAConfig) -> tuple[float, float]:
    """(weight storage in KiB, compression against dense float32): the
    compiled program's at a quantized point, float32 otherwise."""
    if cfg.spe is not None and cfg.spe.quantized:
        prog = compiler.compile_model(params, cfg)
        return prog.weight_hbm_bytes() / 1024, prog.compression_ratio()
    return vadetect.param_count(params) * 4 / 1024, 1.0


def row(name: str, point: dict) -> tuple[str, float, str]:
    """A point's benchmark row: the mean accuracy of its last 10 steps
    (over 10, as the reference divides), its storage and compression."""
    acc = sum(point["accuracies"][-10:]) / 10
    return (
        f"ablation.{name}", point["us_per_step"],
        f"acc={acc:.4f} weights_kb={point['weights_kb']:.1f} "
        f"compress={point['compress']:.2f}x",
    )


def run(
    steps: int = STEPS, device: _device.DeviceLike = None
) -> list[tuple[str, float, str]]:
    """One row per point of POINTS. `device=None` means the CUDA card
    (raises without one)."""
    return [
        row(name, train_point(spe, steps=steps, device=device))
        for name, spe in POINTS
    ]


def main() -> None:
    for name, us, derived in run():
        print(f"{name},{us:.2f},{derived}")


if __name__ == "__main__":
    main()

"""VA inference demo: mixed-precision CMUL points on the compiled chip, on
the card (port of `examples/va_inference_demo.py`).

    PYTHONPATH=src python -m repro_torch.examples.va_inference_demo

Compares the paper operating point (uniform 8-bit) against the
mixed-precision point (8/4-bit layers) and the dense baseline, each
trained from the same seed — the flexibility the reconfigurable
multiplier exists for — reporting accuracy, storage, energy, and power
from the chip model, plus a check that the kernel path (7 launches of
the CUDA `nm_spmm` a sparse program) agrees in argmax with the
reference path.

The test set is the port's `iegm.synth_batch` from a generator seeded
777 (torch cannot reproduce `jax.random`). `main(device="cpu")` runs the
same demo on the CPU, with the kernel's plain version.
"""

from __future__ import annotations

import torch

from repro_torch import _device, optim
from repro_torch.configs import va_cnn
from repro_torch.core import compiler, vadetect
from repro_torch.data import iegm
from repro_torch.train import trainer


def train(
    cfg: vadetect.VAConfig, steps: int = 200, seed: int = 0,
    device: _device.DeviceLike = None,
) -> dict:
    """`steps` adam steps at batch 64 from `seed`; returns the params."""
    dev = _device.resolve(device)
    params = vadetect.init(torch.Generator().manual_seed(seed), cfg, device=dev)
    opt = optim.adam(3e-3)
    state = trainer.init_state(params, opt, device=dev)
    step = trainer.make_train_step(
        lambda p, b: vadetect.loss_fn(p, b, cfg), opt, clip_norm=1.0
    )
    stream = iegm.IEGMStream(batch=64, seed=seed, device=dev)
    for i in range(steps):
        state, _ = step(state, stream.batch_at(i))
    return state["params"]


def main(device: _device.DeviceLike = None, steps: int = 200) -> list[dict]:
    """Train, compile and compare the three points; prints a line each and
    returns them as dicts. `device=None` means the CUDA card (raises
    without one)."""
    dev = _device.resolve(device)
    test = iegm.synth_batch(
        torch.Generator(device=dev).manual_seed(777), 512, device=dev)

    out = []
    for name, cfg in [("paper_8bit", va_cnn.CONFIG),
                      ("mixed_8_4bit", va_cnn.MIXED),
                      ("dense_float", va_cnn.DENSE)]:
        params = train(cfg, steps=steps, device=dev)
        logits = vadetect.apply(params, test["signal"], cfg, train=False)
        acc = float((logits.argmax(-1) == test["label"]).to(torch.float32).mean())
        if cfg.spe is not None:
            program = compiler.compile_model(params, cfg)
            kb = program.weight_hbm_bytes() / 1024
            s = program.report.summary()
            # kernel path agreement on the compiled program
            y_ref = compiler.execute(program, test["signal"][:32], cfg,
                                     path="reference")
            y_ker = compiler.execute(program, test["signal"][:32], cfg,
                                     path="kernel")
            agree = float(
                (y_ref.argmax(-1) == y_ker.argmax(-1)).to(torch.float32).mean()
            )
            energy_nj = program.report.energy_j * 1e9
            print(f"{name:14s} acc={acc:.4f} weights={kb:6.1f}KiB "
                  f"energy/inf={energy_nj:6.2f}nJ "
                  f"power={s['avg_power_uW']:5.2f}uW "
                  f"kernel_argmax_agree={agree:.2f}")
            out.append({"name": name, "acc": acc, "weights_kib": kb,
                        "energy_nj": energy_nj,
                        "power_uW": s["avg_power_uW"],
                        "kernel_argmax_agree": agree})
        else:
            n = vadetect.param_count(params)
            print(f"{name:14s} acc={acc:.4f} weights={n*4/1024:6.1f}KiB "
                  f"(f32 baseline)")
            out.append({"name": name, "acc": acc, "weights_kib": n * 4 / 1024})
    return out


if __name__ == "__main__":
    main()

"""The co-design compiler: trained model -> accelerator program.

Port of `repro.core.compiler`. `compile_model` freezes every SPE layer of
a trained VA detector into `CompiledLayer` form (balanced-pruned,
compressed, quantized, packed), checks the balance invariant that makes
the chip's synchronous schedule work, and attaches the perf-model report.
`execute` runs the program with the chip's im2col dataflow; its sparse
layers go through `spe_matmul(path=...)`, whose ``kernel`` path is the
hand-written CUDA `nm_spmm` on the card.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import perf_model, sparsity, vadetect
from repro_torch.core.spe import (
    CompiledLayer,
    SPEConfig,
    compile_layer,
    im2col,
    spe_matmul,
)


@dataclasses.dataclass
class AcceleratorProgram:
    """Everything the chip needs for inference on one network."""

    layers: dict[str, CompiledLayer]
    biases: dict[str, torch.Tensor]
    layer_meta: list[dict]  # static shapes/strides (the schedule skeleton)
    report: perf_model.ChipReport

    def weight_hbm_bytes(self) -> int:
        return sum(l.hbm_bytes() for l in self.layers.values())

    def dense_fp32_bytes(self) -> int:
        return sum(
            l.k_dense * l.values_q.shape[1] * 4 for l in self.layers.values()
        )

    def compression_ratio(self) -> float:
        return self.dense_fp32_bytes() / max(1, self.weight_hbm_bytes())

    def to(self, device: torch.device) -> "AcceleratorProgram":
        return dataclasses.replace(
            self,
            layers={k: l.to(device) for k, l in self.layers.items()},
            biases={k: b.to(device) for k, b in self.biases.items()},
        )


def chip_report(meta: list[dict]) -> perf_model.ChipReport:
    """The perf-model report of a program's static layer description."""
    return perf_model.chip_report([
        perf_model.LayerWorkload(
            name=m["name"],
            c_in=m["c_in"],
            c_out=m["c_out"],
            ksize=m["ksize"],
            t_out=m["t_out"],
            macs=m["macs"],
            bits=m["bits"],
            keep_frac=m["keep_frac"],
            sparse=m["sparse"],
        )
        for m in meta
    ])


def compile_model(
    params: dict, cfg: vadetect.VAConfig = vadetect.VAConfig()
) -> AcceleratorProgram:
    """Freeze a trained VA detector into the chip's program format, on the
    device its parameters live on."""
    meta = vadetect.layer_shapes(cfg)
    layers: dict[str, CompiledLayer] = {}
    biases: dict[str, torch.Tensor] = {}
    for i, m in enumerate(meta):
        name = m["name"]
        spe = cfg.layer_spe(i)
        w = params[name]["w"].detach().to(torch.float32)
        ks, c_in, c_out = w.shape
        w2 = w.reshape(ks * c_in, c_out)
        lcfg = spe if spe is not None else SPEConfig(sparse=False, quantized=False)
        if lcfg.sparse:
            # pad the contraction to whole groups (the chip pads
            # redundant units with zeros)
            w2 = F.pad(w2, (0, 0, 0, (-w2.shape[0]) % lcfg.group_size))
            mask = sparsity.balanced_prune_mask(w2, lcfg.sparsity_cfg)
            if not sparsity.verify_balance(mask, lcfg.sparsity_cfg):
                raise RuntimeError(f"{name}: balanced-sparsity invariant broken")
        layers[name] = compile_layer(w2, lcfg)
        biases[name] = params[name]["b"].detach().to(torch.float32)
    return AcceleratorProgram(
        layers=layers, biases=biases, layer_meta=meta, report=chip_report(meta)
    )


def execute(
    program: AcceleratorProgram,
    x: torch.Tensor,
    cfg: vadetect.VAConfig = vadetect.VAConfig(),
    *,
    path: str = "reference",
) -> torch.Tensor:
    """Run the compiled program (software twin of the chip's execution).

    Per layer: SAME-padded im2col patches in (tap, channel) order,
    zero-padded to the compiler's group-padded K, then `spe_matmul` on
    `path`. Returns (B, 2) logits.
    """
    h = vadetect.pad_input(x)
    n_layers = len(cfg.layers)
    for i, m in enumerate(program.layer_meta):
        name = m["name"]
        layer = program.layers[name]
        flat = im2col(h, m["ksize"], m["stride"])
        if flat.shape[-1] < layer.k_dense:  # compiler padded K to groups
            flat = F.pad(flat, (0, layer.k_dense - flat.shape[-1]))
        y = spe_matmul(flat, layer, path=path) + program.biases[name]
        h = torch.relu(y) if i < n_layers - 1 else y
    return h.mean(dim=1)

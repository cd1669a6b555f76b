"""Bucketed batched inference over the compiled accelerator program.

Port of `repro.stream.runner` on one device (no mesh yet). Compute paths:

  * ``twin``      — the program's sparse-quantized weights decompressed
    once at construction into dequantized dense conv weights and run
    through `F.conv1d` in full float32: numerically the per-layer
    ``dense`` path, at convolution speed.
  * ``reference`` / ``kernel`` / ``dense`` — `compiler.execute`'s
    per-layer im2col dataflow; ``kernel`` is the CUDA `nm_spmm` on the
    card.

Time accounting is the modelled chip's: every segment costs
`program.report.latency_s` (the perf model, not a measurement).
"""

from __future__ import annotations

import torch

from repro_torch import _device
from repro_torch.core import compiler, sparsity, vadetect
from repro_torch.core.spe import conv1d_same


def twin_weights(program: compiler.AcceleratorProgram) -> list[dict]:
    """Decompress the program's layers into dequantized dense conv weights
    (ks, c_in, c_out) — what `spe_matmul`'s "dense" path contracts with."""
    out = []
    for m in program.layer_meta:
        layer = program.layers[m["name"]]
        ks, c_in, c_out = m["ksize"], m["c_in"], m["c_out"]
        vals = layer.values_q.to(torch.float32)
        if layer.sparse:
            dense = sparsity.decompress(
                vals,
                layer.select,
                sparsity.SparsityConfig(layer.group_size, layer.keep),
                layer.k_dense,
            )
        else:
            dense = vals
        # drop the compiler's group padding of K before the reshape
        w = (dense * layer.scale)[: ks * c_in].reshape(ks, c_in, c_out)
        out.append({"w": w, "b": program.biases[m["name"]]})
    return out


def _twin_logits(
    weights: list[dict], meta: list[dict], x: torch.Tensor
) -> torch.Tensor:
    """(B, 512) -> (B, 2) logits through the decompressed conv twin."""
    h = vadetect.pad_input(x)
    n = len(meta)
    for i, (m, wb) in enumerate(zip(meta, weights)):
        y = conv1d_same(h, wb["w"], m["stride"]) + wb["b"]
        h = torch.relu(y) if i < n - 1 else y
    return h.mean(dim=1)


class FleetRunner:
    """Fixed-shape batched classifier over one compiled program, on one
    device (`None` means the CUDA card; the program is moved there)."""

    def __init__(
        self,
        program: compiler.AcceleratorProgram,
        cfg: vadetect.VAConfig = vadetect.VAConfig(),
        *,
        path: str = "twin",
        device: _device.DeviceLike = None,
    ):
        self.device = _device.resolve(device)
        self.program = program.to(self.device)
        self.cfg = cfg
        self.path = path
        if path == "twin":
            weights = twin_weights(self.program)
            meta = self.program.layer_meta
            self._logits = lambda x: _twin_logits(weights, meta, x)
        else:
            self._logits = lambda x: compiler.execute(
                self.program, x, cfg, path=path
            )

    def logits(self, signals) -> torch.Tensor:
        """(bucket, 512) -> (bucket, 2) float32 logits on the runner's
        device."""
        x = torch.as_tensor(signals, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            return self._logits(x)

    def classify(self, signals) -> torch.Tensor:
        """(bucket, 512) f32 -> (bucket,) int32 predictions."""
        return torch.argmax(self.logits(signals), dim=-1).to(torch.int32)

    # -- accounting (the modelled chip's time, not a measurement) ----------

    @property
    def n_devices(self) -> int:
        return 1

    @property
    def chip_latency_s(self) -> float:
        """Modelled silicon latency of one segment inference."""
        return self.program.report.latency_s

    def batch_service_s(self, bucket: int) -> float:
        """Modelled service time of one packed bucket: the chip twin runs
        its ceil(bucket/N) segments serially (padding rows included)."""
        per_dev = -(-bucket // max(1, self.n_devices))
        return per_dev * self.chip_latency_s

    def modeled_segments_per_s(self) -> float:
        """Modelled chip-fleet throughput (N chips, saturated)."""
        return self.n_devices / self.chip_latency_s


"""Core: the paper's contribution as PyTorch functions.

- quant      : symmetric per-channel quantization + packed bit-plane storage
- sparsity   : co-design balanced pruning (select-index compressed format)
- spe        : sparse-quantized linear/conv operators (3 compute paths)
- vadetect   : the 8-layer 1-D FCN VA detector + 6-segment voting
- compiler   : trained model -> AcceleratorProgram (chip format + schedule)
- perf_model : analytic cycle/energy/power model of the 2x4x4x16 chip
"""

from repro_torch.core import compiler, perf_model, quant, sparsity, spe, vadetect

__all__ = [
    "compiler",
    "perf_model",
    "quant",
    "sparsity",
    "spe",
    "vadetect",
]

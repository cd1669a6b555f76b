"""va-cnn — the paper's own workload: 8-layer 1-D FCN VA detector.

The model lives in `core.vadetect`; this module exposes its operating
points (port of `repro.configs.va_cnn`).
"""

from repro_torch.core.spe import SPEConfig
from repro_torch.core.vadetect import VAConfig

# Paper operating point: 50% balanced sparsity, 8-bit weights.
CONFIG = VAConfig(
    spe=SPEConfig(bits=8, group_size=16, keep=8, sparse=True,
                  quantized=True)
)

# Mixed-precision point: early layers 8-bit, middle 4-bit, late 8-bit.
MIXED = VAConfig(
    spe=SPEConfig(bits=8, group_size=16, keep=8, sparse=True,
                  quantized=True),
    layer_bits=(8, 8, 4, 4, 4, 4, 8, 8),
)

"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1:2 [arXiv:2402.19427; hf].

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000. Pattern
(rglru, rglru, local) x 8 + (rglru, rglru) tail = 26 layers. Window 2048,
head_dim 256 (Griffin-2B). O(1)/windowed state -> runs long_500k.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256_000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    act="geglu",
    norm="rmsnorm",
    scale_embed=True,
    lru_width=2560,
    conv_width=4,
    kv_mode="replicate",  # kv=1 (MQA): replicate over TP
    supports_decode=True,
    supports_long=True,
)

REDUCED = ArchConfig(
    name="recurrentgemma-reduced",
    family="hybrid",
    n_layers=5,  # 1 full period + (r, r) tail — exercises tail path
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab=512,
    pattern=("rglru", "rglru", "local"),
    window=8,
    act="geglu",
    norm="rmsnorm",
    scale_embed=True,
    lru_width=64,
    conv_width=4,
    kv_mode="replicate",
    supports_decode=True,
    supports_long=True,
)

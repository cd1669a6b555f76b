"""qwen3-8b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B].

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936, head_dim=128.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    supports_decode=True,
    supports_long=False,
)

REDUCED = ArchConfig(
    name="qwen3-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    qk_norm=True,
    rope_theta=1e6,
    supports_decode=True,
    supports_long=False,
)

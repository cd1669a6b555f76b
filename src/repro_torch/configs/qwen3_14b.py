"""qwen3-14b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family].

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936, head_dim=128.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    supports_decode=True,
    supports_long=False,
)

REDUCED = ArchConfig(
    name="qwen3-14b-reduced",
    family="dense",
    n_layers=3,
    d_model=80,
    n_heads=5,
    n_kv_heads=1,
    head_dim=16,
    d_ff=160,
    vocab=512,
    qk_norm=True,
    rope_theta=1e6,
    supports_decode=True,
    supports_long=False,
)

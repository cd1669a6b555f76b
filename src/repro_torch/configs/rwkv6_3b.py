"""rwkv6-3b [ssm] — Finch, data-dependent decay [arXiv:2404.05892; hf].

32L d_model=2560 (attn-free) d_ff=8960 vocab=65536. O(1) decode state ->
runs the long_500k cell.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,  # wkv heads = d_model / 64 (bookkeeping; attn-free)
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    pattern=("rwkv",),
    norm="layernorm",
    rwkv_head_dim=64,
    supports_decode=True,
    supports_long=True,
)

REDUCED = ArchConfig(
    name="rwkv6-reduced",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    pattern=("rwkv",),
    norm="layernorm",
    rwkv_head_dim=16,
    supports_decode=True,
    supports_long=True,
)

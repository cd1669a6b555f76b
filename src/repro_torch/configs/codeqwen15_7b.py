"""codeqwen1.5-7b [dense] — qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H (MHA, kv=32) d_ff=13440 vocab=92416. QKV biases
(qwen1.5 family). Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    rope_theta=1e6,
    supports_decode=True,
    supports_long=False,
)

REDUCED = ArchConfig(
    name="codeqwen-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    qkv_bias=True,
    rope_theta=1e6,
    supports_decode=True,
    supports_long=False,
)

"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (kv=16) d_ff=1024 (per expert) vocab=50304,
MoE 64e top-8, qk_norm (OLMoE uses QK-norm).
"""

from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    qk_norm=True,
    moe=MoESpec(num_experts=64, top_k=8, d_ff_expert=1024),
    rope_theta=1e4,
    supports_decode=True,
    supports_long=False,
)

REDUCED = ArchConfig(
    name="olmoe-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab=512,
    qk_norm=True,
    moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=64,
                capacity_factor=8.0),  # dropless at smoke scale
    supports_decode=True,
    supports_long=False,
)

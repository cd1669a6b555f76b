"""llama4-scout-17b-a16e [moe] — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) head_dim=128, MoE 16 experts top-1
(d_ff_expert=8192) + shared expert; chunked attention (8192) on 3/4
layers, global on 1/4 -> long_500k runs (global KV at B=1 is linear).
"""

from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202_048,
    pattern=("chunked", "chunked", "chunked", "global"),
    window=8192,
    moe=MoESpec(
        num_experts=16,
        top_k=1,
        d_ff_expert=8192,
        shared_expert_ff=8192,
    ),
    rope_theta=5e5,
    supports_decode=True,
    supports_long=True,
)

REDUCED = ArchConfig(
    name="llama4-reduced",
    family="moe",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    pattern=("chunked", "chunked", "chunked", "global"),
    window=8,
    moe=MoESpec(
        num_experts=4, top_k=1, d_ff_expert=128, shared_expert_ff=128,
        capacity_factor=8.0,  # dropless at smoke scale: decode==train exact
    ),
    rope_theta=5e5,
    supports_decode=True,
    supports_long=True,
)

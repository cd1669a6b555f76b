"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) head_dim=128 d_ff=29568 vocab=152064.
Backbone only (assignment): the vision frontend is a stub — M-RoPE
consumes (t, h, w) position grids; the text stub feeds equal rows, which
reduces exactly to 1-D RoPE. Sections (16, 24, 24) of hd/2=64.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    supports_decode=True,
    supports_long=False,
    # 72B at 1M tokens/step on 256 chips: 4 microbatches bound the
    # activation residency (saved scan carries + logits CE) under HBM.
    train_microbatches=4,
)

REDUCED = ArchConfig(
    name="qwen2vl-reduced",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    qkv_bias=True,
    mrope_sections=(4, 2, 2),
    rope_theta=1e6,
    supports_decode=True,
    supports_long=False,
)

"""gemma2-9b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118; hf].

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000, head_dim=256,
window 4096, attn softcap 50, final softcap 30, GeGLU, sandwich norms,
sqrt(d) embedding scale.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256_000,
    pattern=("local", "global"),
    window=4096,
    act="geglu",
    attn_softcap=50.0,
    final_softcap=30.0,
    sandwich_norm=True,
    scale_embed=True,
    rope_theta=1e4,
    supports_decode=True,
    supports_long=False,  # half the layers are global full attention
)

REDUCED = ArchConfig(
    name="gemma2-reduced",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    pattern=("local", "global"),
    window=8,
    act="geglu",
    attn_softcap=50.0,
    final_softcap=30.0,
    sandwich_norm=True,
    scale_embed=True,
    supports_decode=True,
    supports_long=False,
)

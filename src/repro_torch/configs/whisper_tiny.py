"""whisper-tiny [audio] — enc-dec, conv frontend stub [arXiv:2212.04356].

4L (enc) + 4L (dec) d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
Modality frontend is a stub: input_specs() provides precomputed frame
embeddings (B, 1500, 384). Tiny model -> pure-DP parallelism profile
(use_tp=False): the 'model' mesh axis joins data parallelism instead of
fragmenting 6 heads over 16 shards.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,  # decoder
    enc_layers=4,
    enc_seq=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    use_tp=False,
    fsdp=False,
    supports_decode=True,
    supports_long=False,  # decoder context is architecturally 448
)

REDUCED = ArchConfig(
    name="whisper-reduced",
    family="audio",
    n_layers=2,
    enc_layers=2,
    enc_seq=16,
    d_model=48,
    n_heads=3,
    n_kv_heads=3,
    d_ff=96,
    vocab=256,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    use_tp=False,
    fsdp=False,
    supports_decode=True,
    supports_long=False,
)

"""LM substrate: attention, layers, the decoder stack with its MoE and
recurrent (RG-LRU, RWKV-6) blocks, the whisper encoder-decoder, and the
API over them."""

from repro_torch.models import (
    api,
    attention,
    layers,
    moe,
    rglru,
    rwkv6,
    transformer,
    whisper,
)

__all__ = ["api", "attention", "layers", "moe", "rglru", "rwkv6",
           "transformer", "whisper"]

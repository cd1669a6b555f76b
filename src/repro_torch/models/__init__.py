"""LM substrate: attention, layers, the decoder stack and its API (the
dense attention families; MoE, RG-LRU, RWKV-6 and whisper are ROADMAP.md
queue 1 item 6)."""

from repro_torch.models import api, attention, layers, transformer

__all__ = ["api", "attention", "layers", "transformer"]

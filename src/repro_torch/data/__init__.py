"""Data: the synthetic IEGM pipeline and the synthetic LM token stream."""

from repro_torch.data import iegm, lm

__all__ = ["iegm", "lm"]

"""Data: the synthetic IEGM pipeline."""

from repro_torch.data import iegm

__all__ = ["iegm"]

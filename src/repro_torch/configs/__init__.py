"""Configs: the paper's va_cnn operating points."""

from repro_torch.configs import va_cnn

__all__ = ["va_cnn"]

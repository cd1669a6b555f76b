"""Training (port of `repro.train`); for now the single-device trainer."""

from repro_torch.train import trainer

__all__ = ["trainer"]

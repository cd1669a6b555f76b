"""Distributed training pieces (port of `repro.dist`); for now the
single-device micro-batch accumulation."""

from repro_torch.dist import accumulate

__all__ = ["accumulate"]

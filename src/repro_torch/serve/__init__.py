"""Serving: the paper's VA diagnosis service."""

from repro_torch.serve import va_service
from repro_torch.serve.va_service import Diagnosis, VAService

__all__ = ["Diagnosis", "VAService", "va_service"]

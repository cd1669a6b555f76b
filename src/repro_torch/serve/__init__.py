"""Serving: the batched LM engine on the dense slot pool (batched prefill
admission with per-slot cache scatter) and the paper's VA diagnosis
service."""

from repro_torch.serve import engine, paging, seating, va_service
from repro_torch.serve.engine import (
    EncDecUnsupportedError,
    Engine,
    Request,
    generate,
    request_key,
    sample_tokens,
)
from repro_torch.serve.seating import gather_slots, scatter_slots
from repro_torch.serve.va_service import Diagnosis, VAService

__all__ = [
    "engine",
    "paging",
    "seating",
    "va_service",
    "Diagnosis",
    "EncDecUnsupportedError",
    "Engine",
    "Request",
    "VAService",
    "gather_slots",
    "generate",
    "request_key",
    "sample_tokens",
    "scatter_slots",
]

"""Serving: the batched LM engine (batched prefill admission with per-slot
cache scatter, the paged KV cache and chunked prefill), the async
transport frontend with admission control, and the paper's VA diagnosis
service."""

from repro_torch.serve import engine, frontend, paging, seating, va_service
from repro_torch.serve.engine import (
    EncDecUnsupportedError,
    Engine,
    Request,
    generate,
    request_key,
    sample_tokens,
)
from repro_torch.serve.frontend import (
    Frontend,
    FrontendConfig,
    InProcClient,
    SocketClient,
    TokenBucket,
)
from repro_torch.serve.seating import (
    gather_pages,
    gather_slots,
    scatter_pages,
    scatter_slots,
)
from repro_torch.serve.va_service import Diagnosis, VAService

__all__ = [
    "engine",
    "frontend",
    "paging",
    "seating",
    "va_service",
    "Diagnosis",
    "EncDecUnsupportedError",
    "Engine",
    "Frontend",
    "FrontendConfig",
    "InProcClient",
    "Request",
    "SocketClient",
    "TokenBucket",
    "VAService",
    "gather_pages",
    "gather_slots",
    "generate",
    "request_key",
    "sample_tokens",
    "scatter_pages",
    "scatter_slots",
]

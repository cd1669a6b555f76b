"""The paper's deployment: VA diagnosis service (6-segment voting).

Port of `repro.serve.va_service`: a thin facade that classifies segments
through `stream.runner.FleetRunner` in power-of-two buckets and votes
per patient with `core.vadetect.vote`. Latency accounting is the chip
perf model's (modelled, not measured).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import _device
from repro_torch.core import compiler, vadetect
from repro_torch.core.perf_model import ChipReport
from repro_torch.stream.runner import FleetRunner


@dataclasses.dataclass
class Diagnosis:
    patient: int
    is_va: bool
    segment_preds: list[int]
    chip_latency_us: float


def _bucket_for(n: int) -> int:
    """Smallest power-of-two batch shape >= n: the facade's bucket ladder."""
    b = 1
    while b < n:
        b *= 2
    return b


class VAService:
    """Batched VA diagnosis over a compiled accelerator program, on one
    device (`None` means the CUDA card)."""

    def __init__(
        self,
        program: compiler.AcceleratorProgram,
        cfg: vadetect.VAConfig = vadetect.VAConfig(),
        *,
        path: str = "reference",
        device: _device.DeviceLike = None,
    ):
        self._runner = FleetRunner(program, cfg, path=path, device=device)
        self.program = self._runner.program
        self.cfg = cfg
        self.path = path

    @property
    def report(self) -> ChipReport:
        return self.program.report

    def diagnose_batch(self, recordings) -> list[Diagnosis]:
        """recordings (P, 6, 512) -> one Diagnosis per patient."""
        rec = torch.as_tensor(
            recordings, dtype=torch.float32, device=self._runner.device
        )
        p, s, t = rec.shape
        if s != vadetect.VOTE_SEGMENTS:
            raise ValueError(f"expected {vadetect.VOTE_SEGMENTS} segments, got {s}")
        flat = rec.reshape(p * s, t)
        bucket = _bucket_for(p * s)
        if bucket > p * s:
            flat = F.pad(flat, (0, 0, 0, bucket - p * s))
        preds = self._runner.classify(flat)[: p * s].reshape(p, s)
        votes = vadetect.vote(preds).tolist()
        seg = preds.tolist()
        lat = self.report.latency_s * 1e6 * s  # 6 inferences per diagnosis
        return [
            Diagnosis(
                patient=i,
                is_va=bool(votes[i]),
                segment_preds=seg[i],
                chip_latency_us=lat,
            )
            for i in range(p)
        ]

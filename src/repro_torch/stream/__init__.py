"""repro_torch.stream — fleet-scale streaming VA monitoring.

Port of `repro.stream` on one device. The layer between the chip twin
(`core.compiler` / `core.perf_model`) and the fleet: per-patient IEGM
segment sources (`sources`), a deadline-aware pad-to-bucket
micro-batching scheduler with urgent-patient preemption (`scheduler`), a
bucketed inference runner over the compiled accelerator program
(`runner`, the CUDA `nm_spmm` on its ``kernel`` path), vectorized
per-patient 6-segment vote state machines on the runner's device
(`vote`), fleet counters (`metrics`), and the virtual-time simulation
facade (`fleet`).
"""

from repro_torch.stream.fleet import FleetConfig, simulate
from repro_torch.stream.metrics import FleetMetrics
from repro_torch.stream.runner import FleetRunner, twin_weights
from repro_torch.stream.scheduler import (
    PRIORITY_ROUTINE,
    PRIORITY_URGENT,
    MicroBatchScheduler,
    PackedBatch,
    SchedulerConfig,
)
from repro_torch.stream.sources import (
    SEGMENT_PERIOD_S,
    FleetSource,
    RingBuffer,
    SegmentRef,
    SourceConfig,
    advance_virtual_time,
)
from repro_torch.stream import vote

__all__ = [
    "FleetConfig",
    "FleetMetrics",
    "FleetRunner",
    "FleetSource",
    "MicroBatchScheduler",
    "PackedBatch",
    "PRIORITY_ROUTINE",
    "PRIORITY_URGENT",
    "RingBuffer",
    "SEGMENT_PERIOD_S",
    "SchedulerConfig",
    "SegmentRef",
    "SourceConfig",
    "advance_virtual_time",
    "simulate",
    "twin_weights",
    "vote",
]

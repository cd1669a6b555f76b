"""Streaming: the bucketed batched runner over a compiled program. The
fleet pieces of `repro.stream` (sources, scheduler, vote, metrics, fleet)
are still to be ported."""

from repro_torch.stream.runner import FleetRunner, twin_weights

__all__ = ["FleetRunner", "twin_weights"]

"""PyTorch telemetry probes: distinct call signatures, step timing, memory.

Port of `repro.obs.jaxprobe`. Eager PyTorch has no compile cache, so
what a jitted cell's cache size counted there — one compiled variant per
distinct input signature — a tracked cell counts here directly:

  * **Signature visibility** — every cell the stream path runs (a
    bucket's classify, the vote update) is registered by name; a tracked
    cell records the distinct (shape, dtype) signatures of its tensor
    arguments, and `cache_sizes()` reads each cell's count, so "did a new
    shape reach the cell after warmup" is one snapshot diff
    (`new_misses`). The scheduler's pad-to-bucket contract keeps a
    classify cell at one signature per declared bucket.
  * **Bounded step timing** — `timed_call` synchronizes the CUDA stream
    of the result, so the observed duration is device work, not
    dispatch.
  * **Device memory gauges** — `device_memory_bytes()` reads
    `torch.cuda.memory_allocated` (`max_memory_allocated` for the
    peak), summed over the visible cards; 0 on a host without one.

The reference's `cost_gauges` reads an XLA executable's cost analysis;
there is no such executable here, so it is not ported.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _signature(x) -> tuple:
    """Hashable signature of one call argument: (shape, dtype) of a
    tensor or array, recursing into tuples, lists and dicts; other values
    stand for their type. Built on every tracked call, so kept cheap: a
    tensor or array is anything with a `shape`, taken as given (a
    `torch.Size` is a tuple) with the dtype object."""
    shape = getattr(x, "shape", None)  # a tensor or an array
    if shape is not None:
        return (shape, x.dtype)
    if isinstance(x, (tuple, list)):
        return tuple([_signature(v) for v in x])
    if isinstance(x, dict):
        return tuple([(k, _signature(v)) for k, v in sorted(x.items())])
    return (type(x).__name__,)


class TrackedCell:
    """Transparent wrapper an enabled probe returns from `track`: records
    each call's signature, then delegates to `fn`."""

    def __init__(self, name: str, fn: Callable):
        self.name = name
        self.fn = fn
        self.signatures: set = set()

    def __call__(self, *args, **kwargs):
        self.signatures.add(
            (_signature(args), _signature(kwargs) if kwargs else ()))
        return self.fn(*args, **kwargs)


class TorchProbe:
    """Named registry of cells for signature (recompile) accounting.

    A disabled probe drops registrations; an enabled one keeps them for
    the lifetime of the run."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._cells: dict[str, TrackedCell] = {}

    def track(self, name: str, fn):
        """Register `fn` under `name` (later registrations under the same
        name win). Returns a call-through `TrackedCell` when enabled
        (disabled probes return `fn` unchanged) so call sites can wrap in
        place."""
        if not self.enabled:
            return fn
        cell = self._cells[name] = TrackedCell(name, fn)
        return cell

    def cells(self) -> dict:
        """name -> `TrackedCell` for every tracked cell."""
        return dict(sorted(self._cells.items()))

    def cache_sizes(self) -> dict:
        """name -> distinct signature count for every tracked cell (the
        BENCH `telemetry.recompiles` section)."""
        return {
            name: len(cell.signatures)
            for name, cell in sorted(self._cells.items())
        }

    def snapshot(self) -> dict:
        return self.cache_sizes()

    def new_misses(self, since: dict) -> dict:
        """Cells that saw new signatures after `since` (a `snapshot()`),
        name -> extra signature count. Empty means no new shape reached
        any cell — the regression-guard condition."""
        out = {}
        for name, n in self.cache_sizes().items():
            before = since.get(name)
            if before is not None and n > before:
                out[name] = n - before
        return out


class _NullProbe:
    __slots__ = ()
    enabled = False

    def track(self, name, fn):
        return fn

    def cells(self):
        return {}

    def cache_sizes(self):
        return {}

    snapshot = cache_sizes

    def new_misses(self, since):
        return {}


NULL_PROBE = _NullProbe()


# ---------------------------------------------------------------------------
# timing / memory
# ---------------------------------------------------------------------------


def synchronize(x) -> None:
    """Wait for the CUDA stream of every CUDA tensor in `x` (a tensor or
    a tuple/list of them); nothing to wait for on the CPU."""
    if isinstance(x, (tuple, list)):
        for v in x:
            synchronize(v)
    elif isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()


def timed_call(histogram, fn, *args, **kwargs):
    """Call `fn`, wait for its result's stream, and observe the bounded
    duration into `histogram` (a registry histogram or the null one).
    Returns the (ready) result."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    synchronize(out)
    histogram.observe(time.perf_counter() - t0)
    return out


def device_memory_bytes(peak: bool = False) -> int:
    """Bytes the caching allocator holds for tensors on the visible
    cards (`peak=True`: the high-water mark since the last reset); 0 on
    a host without a card."""
    if not torch.cuda.is_available():
        return 0
    read = torch.cuda.max_memory_allocated if peak else torch.cuda.memory_allocated
    return sum(int(read(i)) for i in range(torch.cuda.device_count()))


def observe_memory(registry) -> int:
    """Sample device memory into the `torch.device_bytes` gauge: its
    value is the live byte count, its peak at least the allocator's
    high-water mark. Returns the live byte count."""
    n = device_memory_bytes()
    gauge = registry.gauge("torch.device_bytes")
    gauge.set(device_memory_bytes(peak=True))  # raises the peak
    gauge.set(n)
    return n

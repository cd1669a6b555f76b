"""Counted cost of one step — FLOPs, bytes, collectives, memory (port of
`repro.launch.hlo_count`).

The reference walks the optimized HLO text, weighting each computation by
how often it runs, because XLA's cost analysis counts a while-loop body
once. An eager step needs none of that: `count_step` runs the step once
and counts what it does, every loop trip included. So `loops` stays
empty, and the HLO parsing has no counterpart.

  * FLOPs: `torch.utils.flop_counter.FlopCounterMode` (matmuls,
    convolutions, attention), plus what each hand-written kernel's wrapper
    reports for its launch (`obs.torchprobe.add_kernel_cost`: the
    dispatcher does not see a kernel called through `ctypes`);
  * bytes: every non-view op's distinct input and output tensors, read
    or written once each, plus each kernel's reported bytes (the cell
    auditor's recorder, `obs.torchprobe.record_call`). Eager PyTorch fuses nothing,
    so this is the traffic the port's program moves, not what a fusing
    compiler would;
  * collective bytes and calls: `obs.torchprobe.comm_snapshot`'s counts
    over the step (`launch.op_analysis` states the convention);
  * memory: the peak of the live storages over the step (the cyclic
    collector held off, so the reading is repeatable), from
    `torch.distributed._tools.mem_tracker.MemTracker` (torch-internal;
    `tests/test_torch_dryrun.py` pins its reading against a closed form).

Run on fake tensors (`torch._subclasses.fake_tensor.FakeTensorMode`) the
step allocates nothing and launches nothing, on any host: the kernel
wrappers report a fake launch as a real one (`kernels.ops`).
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Any, Callable

from repro_torch.launch.op_analysis import collective_stats
from repro_torch.obs import torchprobe

TOP_N = 10


@dataclasses.dataclass
class StepCost:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    collective_by_op: dict
    collective_counts: dict
    loops: list
    top_bytes: list  # [(bytes, "aten" | "kernel", name)], largest first
    top_flops: list  # [(flops, "aten" | "kernel", name)]
    kernel_launches: dict
    peak_bytes: int  # live storages at the step's peak, arguments included
    output: Any = None


def _top(by_name: dict, kernels: dict) -> list:
    rows = sorted(((float(v), "kernel" if k in kernels else "aten", k)
                   for k, v in by_name.items()), reverse=True)
    return rows[:TOP_N]


def count_step(fn: Callable, *args, **kwargs) -> StepCost:
    """Run `fn(*args, **kwargs)` once under the memory tracker,
    `FlopCounterMode` and the call recorder, and return its counts (the
    step's output on `output`). Inside a `FakeTensorMode` with fake
    arguments nothing is allocated or launched."""
    from torch.distributed._tools.mem_tracker import MemTracker

    info = torchprobe.CellInfo(name="dryrun.step", fn=fn)
    mt = MemTracker()
    arg_tensors = torchprobe._tensors((args, kwargs))
    if arg_tensors:
        mt.track_external(*arg_tensors)
    # a storage counts as live until it is freed: with the cyclic
    # collector off over the step, garbage in cycles stays live to its
    # end, so the peak does not depend on when a collection happens to run
    gc.collect()
    gc.disable()
    try:
        with mt:
            out = torchprobe.record_call(info, *args, **kwargs)
    finally:
        gc.enable()
    rec = info.call_record
    peak = mt.get_tracker_snapshot("peak")
    peak_bytes = max((int(d.get("Total", 0)) for d in peak.values()),
                     default=0)
    coll = collective_stats(rec.collectives, rec.collective_bytes)
    return StepCost(
        flops=float(rec.flops),
        bytes_accessed=float(rec.bytes_accessed),
        collective_bytes=float(coll.total_bytes),
        collective_by_op=coll.bytes_by_op,
        collective_counts=coll.count_by_op,
        loops=[],
        top_bytes=_top(rec.bytes_by_op, rec.kernel_launches),
        top_flops=_top(rec.flops_by_op, rec.kernel_launches),
        kernel_launches=dict(rec.kernel_launches),
        peak_bytes=peak_bytes,
        output=out,
    )

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

  * **Cell metadata for the auditor** (`repro_torch.analysis`) — `track`
    takes the reference's `budget`, `donate` and `sharded_outputs` (and,
    with the last, the `mesh` and `out_specs` the outputs are placed
    under: the reference's `out_shardings`). Eager PyTorch has no program
    to re-lower, so a tracked cell records its first real call as it runs
    (`CallRecord`: the counterpart of the reference's `call_avals`): the
    ops that read a tensor's value on the host, copy between host and
    device or lift host data into a tensor, the float64 tensors, the
    collectives handed to `torch.distributed`, the donated arguments'
    storages before and after, the outputs' shapes, the hand-written
    kernels launched, and the call's flops and bytes. Later calls are the
    plain delegate: the record is made once a cell, never per call.
  * **Cost gauges** — `cost_gauges` folds a recorded call's flops
    (`torch.utils.flop_counter`, plus what each hand-written kernel's
    wrapper adds for its own launch: the dispatcher does not see a kernel
    launched through `ctypes`) and bytes into `<name>.flops` /
    `<name>.bytes_accessed`, the reference's gauges over XLA's cost
    analysis.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Optional

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


# ---------------------------------------------------------------------------
# the first call's record
# ---------------------------------------------------------------------------

# ops whose result the host reads (`.item()`, `int()`, `float()`, `bool()`
# of a tensor, `torch.equal`): on the card each waits for the stream
HOST_READ_OPS = frozenset({
    "aten._local_scalar_dense", "aten.item", "aten.is_nonzero",
    "aten.equal",
})
# ops whose output shape depends on the data: the host must read a count
# from the card to size the result
DATA_DEPENDENT_OPS = frozenset({
    "aten.nonzero", "aten.nonzero_numpy", "aten.argwhere",
    "aten.masked_select", "aten._unique", "aten._unique2",
    "aten.unique_dim", "aten.unique_consecutive",
    "aten.unique_dim_consecutive",
})
# indexing ops that take a boolean mask through `nonzero`
_MASK_INDEX_OPS = frozenset({
    "aten.index", "aten.index_put", "aten.index_put_",
    "aten._index_put_impl_",
})
# ops that copy host data into a tensor (`torch.tensor`, `torch.as_tensor`
# of a list or an array): a copy from the host on the card
LIFT_OPS = frozenset({"aten.lift_fresh", "aten.lift_fresh_copy"})
# ops that only allocate: they read and write nothing, so move no bytes (a
# kernel's output is counted once, by its wrapper's `add_kernel_cost`)
ALLOC_OPS = frozenset({
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided",
})
# collective kinds as the reference's HLO names them; the compressed
# reductions count theirs by function name
_WIRE_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
               "all_to_all": "all-to-all"}


@dataclasses.dataclass(eq=False)
class CallRecord:
    """What one call of a cell did, as `repro_torch.analysis` reads it.

    `host_reads`, `transfers` and `f64` list the offending ops by name
    (with the devices of a copy); `collectives` is the delta of the
    counted collectives over the call, by the reference's kind names;
    `donated` maps each donated argument's index to its storages before
    and after the call and whether the outputs hold them; `outputs` is
    the tree of the output tensors' local shapes (`torch.Size` leaves,
    dicts, and lists for tuples and lists);
    `kernel_launches` the hand-written kernels launched, by name; `flops`
    and `bytes_accessed` the call's cost (`cost_gauges`), and
    `flops_by_op` / `bytes_by_op` the same split by aten op or kernel
    name; `collective_bytes` the bytes handed to the collectives, by kind
    (each call's operand)."""

    ops: int = 0
    host_reads: list = dataclasses.field(default_factory=list)
    transfers: list = dataclasses.field(default_factory=list)
    f64: list = dataclasses.field(default_factory=list)
    collectives: dict = dataclasses.field(default_factory=dict)
    donated: dict = dataclasses.field(default_factory=dict)
    outputs: list = dataclasses.field(default_factory=list)
    kernel_launches: dict = dataclasses.field(default_factory=dict)
    flops: float = 0.0
    bytes_accessed: float = 0.0
    flops_by_op: dict = dataclasses.field(default_factory=dict)
    bytes_by_op: dict = dataclasses.field(default_factory=dict)
    collective_bytes: dict = dataclasses.field(default_factory=dict)


def _tensors(tree) -> list:
    """The tensors of a (nested tuple / list / dict) tree, in leaf order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _shape_tree(tree):
    """The tree of `tree`'s tensor shapes (`torch.Size` leaves; dicts stay
    dicts, tuples and lists become lists; other leaves None)."""
    if isinstance(tree, torch.Tensor):
        return tree.shape
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_shape_tree(v) for v in tree]
    return None


def _storages(tree) -> list:
    return sorted({t.untyped_storage().data_ptr() for t in _tensors(tree)})


class _Costs(threading.local):
    def __init__(self):
        self.active: list = []


_COSTS = _Costs()


def add_kernel_cost(name: str, flops: float, nbytes: float) -> None:
    """A hand-written kernel's wrapper reports its launch: its name, its
    flops and the bytes it reads and writes, into every record open on
    this thread (none: nothing to do)."""
    for rec in _COSTS.active:
        rec.kernel_launches[name] = rec.kernel_launches.get(name, 0) + 1
        rec.flops += flops
        rec.bytes_accessed += nbytes
        rec.flops_by_op[name] = rec.flops_by_op.get(name, 0) + flops
        rec.bytes_by_op[name] = rec.bytes_by_op.get(name, 0) + nbytes


def _recorder(rec: CallRecord):
    """A dispatch mode that fills `rec` from every op the call runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.namespace == "prim":
                # a query of a fake tensor's metadata (`prim.device`): a
                # real tensor answers it without a dispatch
                return out
            name = str(func.overloadpacket)
            rec.ops += 1
            ins = _tensors((args, kwargs))
            outs = _tensors(out)
            if name in HOST_READ_OPS:
                rec.host_reads.append(f"{name} (a host read of a value)")
            elif name in DATA_DEPENDENT_OPS:
                rec.host_reads.append(f"{name} (an output shape read "
                                      f"from the data)")
            elif name in _MASK_INDEX_OPS and any(
                    t.dtype == torch.bool for t in _tensors(args[1:2])):
                rec.host_reads.append(f"{name} with a boolean mask (an "
                                      f"output shape read from the data)")
            if name in LIFT_OPS:
                rec.transfers.append(f"{name} (host data made a tensor)")
            # a 0-dim CPU operand is a scalar argument, not a transfer
            devs = {t.device.type for t in ins
                    if not (t.device.type == "cpu" and t.dim() == 0)}
            devs |= {t.device.type for t in outs}
            if len(devs) > 1:
                src = sorted({str(t.device) for t in ins})
                dst = sorted({str(t.device) for t in outs})
                rec.transfers.append(f"{name} ({','.join(src)} -> "
                                     f"{','.join(dst) or 'host'})")
            if any(t.dtype in (torch.float64, torch.complex128)
                   for t in ins + outs):
                rec.f64.append(name)
            if not (getattr(func, "is_view", False) or name in ALLOC_OPS):
                # keyed on the storage itself (its StorageImpl): a fake
                # tensor's data_ptr is 0 for every storage
                seen = {(t.untyped_storage()._cdata, t.storage_offset(),
                         t.numel()): t for t in ins + outs}
                nbytes = sum(t.numel() * t.element_size()
                             for t in seen.values())
                rec.bytes_accessed += nbytes
                rec.bytes_by_op[name] = rec.bytes_by_op.get(name, 0) + nbytes
            return out

    return Recorder()


def comm_snapshot() -> tuple[dict, dict]:
    """(calls, bytes) by kind name of every collective counted so far in
    this process: `dist.sharding`'s and `dist.compression`'s."""
    from repro_torch.dist import compression, sharding

    calls, nbytes = dict(sharding.comm_calls), dict(sharding.comm_bytes)
    for k, v in compression.wire_calls.items():
        kind = _WIRE_KINDS.get(k, k)
        calls[kind] = calls.get(kind, 0) + v
        nbytes[kind] = nbytes.get(kind, 0) + compression.wire_bytes.get(k, 0)
    return calls, nbytes


def record_call(info: "CellInfo", *args, **kwargs):
    """Call `info.fn(*args, **kwargs)` once under the recorder, keep the
    record on `info.call_record` and return the call's result."""
    from torch.utils.flop_counter import FlopCounterMode

    rec = CallRecord()
    donated = {i: _storages(args[i]) for i in info.donate if i < len(args)}
    calls0, bytes0 = comm_snapshot()
    _COSTS.active.append(rec)
    try:
        with FlopCounterMode(display=False) as flops, _recorder(rec):
            out = info.fn(*args, **kwargs)
    finally:
        _COSTS.active.pop()  # `rec`: calls nest, records too
    calls1, bytes1 = comm_snapshot()
    rec.collectives = {k: v - calls0.get(k, 0) for k, v in calls1.items()
                       if v != calls0.get(k, 0)}
    rec.collective_bytes = {k: bytes1.get(k, 0) - bytes0.get(k, 0)
                            for k in rec.collectives}
    rec.flops += float(flops.get_total_flops())
    for op, n in flops.get_flop_counts().get("Global", {}).items():
        key = str(getattr(op, "overloadpacket", op))
        rec.flops_by_op[key] = rec.flops_by_op.get(key, 0) + float(n)
    held = set(_storages(out)) if donated else set()
    for i, before in donated.items():
        after = _storages(args[i])
        rec.donated[i] = {"before": before, "after": after,
                          "in_outputs": bool(before)
                          and set(before) <= held}
    rec.outputs = _shape_tree(out)
    info.call_record = rec
    return out


@dataclasses.dataclass
class CellInfo:
    """Audit metadata for one tracked cell (the reference's `CellInfo`).

    `budget` is the cell's declared collective budget: kind name -> most
    calls in one call of the cell (`None`: undeclared, the inventory is
    recorded but not gated). `donate` names the arguments the cell writes
    its results into (the reference's `donate_argnums`). With
    `sharded_outputs`, at least one output must be a rank-local block of
    a larger global tensor: `out_specs` on `mesh` say which (the
    reference's `out_shardings`): the outputs' placement specs, as
    `dist.sharding` writes them, in a tree that follows the outputs' (a
    list for a tuple of outputs, dicts by key; an output it does not
    reach is replicated). `call_record` is the first real call's
    `CallRecord`."""

    name: str
    fn: Callable
    budget: Optional[dict] = None
    donate: tuple = ()
    sharded_outputs: bool = False
    mesh: Any = None
    out_specs: Any = None
    call_record: Optional[CallRecord] = None


class TrackedCell:
    """Transparent wrapper an enabled probe returns from `track`: records
    each call's signature and, on the first call, the call itself
    (`record_call`), then delegates to `fn`."""

    def __init__(self, info: CellInfo):
        self.info = info
        self.fn = info.fn
        self.signatures: set = set()

    def __call__(self, *args, **kwargs):
        self.signatures.add(
            (_signature(args), _signature(kwargs) if kwargs else ()))
        if self.info.call_record is None:
            return record_call(self.info, *args, **kwargs)
        return self.fn(*args, **kwargs)


class TorchProbe:
    """Named registry of cells for signature (recompile) accounting and
    the cell auditor.

    A disabled probe drops registrations; an enabled one keeps them for
    the lifetime of the run."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._cells: dict[str, TrackedCell] = {}

    def track(self, name: str, fn, *, budget: Optional[dict] = None,
              donate: tuple = (), sharded_outputs: bool = False,
              mesh: Any = None, out_specs: Any = None):
        """Register `fn` under `name` (later registrations under the same
        name win). Returns a call-through `TrackedCell` when enabled
        (disabled probes return `fn` unchanged) so call sites can wrap in
        place. The keywords feed the cell auditor (`CellInfo`)."""
        if not self.enabled:
            return fn
        cell = self._cells[name] = TrackedCell(CellInfo(
            name=name, fn=fn, budget=budget, donate=tuple(donate),
            sharded_outputs=sharded_outputs, mesh=mesh,
            out_specs=out_specs))
        return cell

    def cells(self) -> dict:
        """name -> `TrackedCell` for every tracked cell (its `info` is
        what `repro_torch.analysis` audits)."""
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

    def track(self, name, fn, **meta):
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


def cost_gauges(registry, name: str, cell) -> dict:
    """Fold a tracked cell's recorded cost (its first call's flops and
    bytes, `CallRecord`) into gauges (`<name>.flops`,
    `<name>.bytes_accessed`); returns the cost dict, the reference's keys
    ("flops", "bytes accessed"), empty for a cell never called."""
    rec = getattr(getattr(cell, "info", cell), "call_record", None)
    if rec is None:
        return {}
    flops, nbytes = f"{name}.flops", f"{name}.bytes_accessed"
    registry.gauge(flops).set(float(rec.flops))
    registry.gauge(nbytes).set(float(rec.bytes_accessed))
    return {"flops": float(rec.flops),
            "bytes accessed": float(rec.bytes_accessed)}

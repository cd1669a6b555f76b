"""Run a function on `world` ranks of a `torch.distributed` process group.

The reference runs one process over many devices (forced host devices on
the CPU, a pod slice on a TPU); the port runs one process per device:

  * a process group already initialized here (the caller's, or one
    `torchrun` brought up from `WORLD_SIZE`, `RANK`, `MASTER_ADDR`) is
    used as it is: `fn` runs on this rank and returns its own result;
  * `torchrun`'s environment without a group: the group is initialized
    from it (`env://`), `fn` runs, the group is destroyed;
  * world 1: the group is initialized in this process over a `FileStore`
    in a temporary directory, `fn` runs, the group is destroyed;
  * otherwise `world` processes are spawned (`torch.multiprocessing`'s
    "spawn" start method), each joining the group over the same
    `FileStore`, so no port is needed. Rank 0's result comes back
    (serialized with `torch.save`); an exception on any rank is raised
    here with that rank's traceback.

The backend is gloo for `device="cpu"` and NCCL for the card, one rank a
card with `torch.cuda.set_device(local rank)` before the group comes up.
There is no fallback: where NCCL or the card is missing, this raises. A
rank that dies or hangs fails the caller: `timeout_s` bounds
`init_process_group` and every collective, and a bound of the whole of a
spawned run (`RUN_TIMEOUT_S` by default) terminates its ranks; a run
`until_stopped` (a server, which ends on SIGINT) has no bound of the
whole. A spawned rank that exits without reporting fails the caller at
once. While spawned ranks run, the caller's first SIGINT is forwarded to
rank 0, which stops the run (a frontend over a mesh: rank 0 stops every
rank), and the caller waits for the ranks as it would have; a second
SIGINT raises `KeyboardInterrupt` here, and the ranks are killed.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import os
import queue as queue_mod
import signal
import tempfile
import threading
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import _device

TIMEOUT_S = 3600.0  # init and each collective
RUN_TIMEOUT_S = 3600.0  # the whole of a spawned run that ends by itself


def backend(device: _device.DeviceLike) -> str:
    """"gloo" on the CPU, "nccl" on the card; raises where the card or
    NCCL is missing (no gloo on the card)."""
    dev = _device.resolve(device)
    if dev.type == "cpu":
        return "gloo"
    if not dist.is_nccl_available():
        raise RuntimeError(
            "this PyTorch has no NCCL: the card's process group needs it "
            "(pass device='cpu' for gloo on the CPU)"
        )
    return "nccl"


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _timeout(timeout_s: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=timeout_s)


def _bind_card(device, local_rank: int) -> None:
    if _device.resolve(device).type == "cuda":
        torch.cuda.set_device(local_rank)


@contextlib.contextmanager
def process_group(device: _device.DeviceLike = "cpu", *,
                  timeout_s: float | None = None):
    """Within the block this process has a default group: the existing
    one, `torchrun`'s (from the environment), or a world-1 group over a
    temporary `FileStore`. A group brought up here is destroyed on
    exit."""
    if dist.is_initialized():
        yield
        return
    t = TIMEOUT_S if timeout_s is None else timeout_s
    be = backend(device)
    if "WORLD_SIZE" in os.environ:
        _bind_card(device, int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(be, timeout=_timeout(t))
        try:
            yield
        finally:
            dist.destroy_process_group()
        return
    _bind_card(device, 0)
    with tempfile.TemporaryDirectory(prefix="repro_torch_pg_") as tmp:
        dist.init_process_group(
            be, init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=0, world_size=1, timeout=_timeout(t),
        )
        try:
            yield
        finally:
            dist.destroy_process_group()


def _to_bytes(obj: Any) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _rank_main(fn, args, kwargs, rank_, world, store, be, device,
               timeout_s, results) -> None:
    """A spawned rank: join the group, run `fn`, report, leave."""
    try:
        _bind_card(device, rank_)
        if be == "gloo":
            # one intra-op thread a rank: the ranks share the host's cores
            torch.set_num_threads(1)
        dist.init_process_group(
            be, init_method=f"file://{store}", rank=rank_,
            world_size=world, timeout=_timeout(timeout_s),
        )
        try:
            out = fn(*args, **kwargs)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank_, True, _to_bytes(out) if rank_ == 0 else None))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank_, False, traceback.format_exc()))


def _forward_sigint(lead) -> Callable[[], None]:
    """Forward the first SIGINT this process gets to the process `lead`;
    a second raises `KeyboardInterrupt` (the stop did not end the run:
    the caller kills the ranks). Returns the undo. A no-op off the main
    thread, where no handler can be set."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None
    sent = []

    def forward(signum, frame) -> None:
        if sent:
            raise KeyboardInterrupt
        sent.append(True)
        os.kill(lead.pid, signal.SIGINT)

    old = signal.signal(signal.SIGINT, forward)
    return lambda: signal.signal(signal.SIGINT, old)


def spawns(world: int) -> bool:
    """True where `run` would spawn the ranks (no group here, no
    `torchrun` environment, and more than one rank)."""
    return not (dist.is_initialized() or "WORLD_SIZE" in os.environ
                or world == 1)


def run(fn: Callable, world: int, *, device: _device.DeviceLike = "cpu",
        args: tuple = (), kwargs: dict | None = None,
        timeout_s: float | None = None, until_stopped: bool = False) -> Any:
    """`fn(*args, **kwargs)` on `world` ranks; returns rank 0's result
    (this rank's, where a group already exists). `fn` must be importable
    by module path where ranks are spawned. `timeout_s` (default
    `TIMEOUT_S`) bounds init and each collective, and the whole of a
    spawned run (default `RUN_TIMEOUT_S`) unless it runs `until_stopped`
    (a server, which ends on SIGINT)."""
    kwargs = kwargs or {}
    t = TIMEOUT_S if timeout_s is None else timeout_s
    whole = (None if until_stopped
             else RUN_TIMEOUT_S if timeout_s is None else timeout_s)
    if not spawns(world):
        with process_group(device, timeout_s=t):
            have = dist.get_world_size()
            if have < world:
                raise SystemExit(
                    f"{world} ranks needed but the process group has {have}"
                )
            return fn(*args, **kwargs)
    be = backend(device)
    if _device.resolve(device).type == "cuda":
        avail = torch.cuda.device_count()
        if world > avail:
            raise SystemExit(
                f"{world} ranks need {world} cards but only {avail} "
                f"available (torch.cuda.device_count())"
            )
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        store = os.path.join(tmp, "store")
        dev = None if device is None else str(device)
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(fn, args, kwargs, r, world, store, be, dev, t, results),
                daemon=True,
            )
            for r in range(world)
        ]
        for p in procs:
            p.start()
        deadline = None if whole is None else time.monotonic() + whole
        out, failures, done, reported = None, [], False, set()
        restore = _forward_sigint(procs[0])
        try:
            while len(reported) < world:
                try:
                    r, ok, payload = results.get(timeout=0.5)
                except queue_mod.Empty:
                    dead = [i for i, p in enumerate(procs)
                            if i not in reported and not p.is_alive()]
                    if dead or (deadline is not None
                                and time.monotonic() > deadline):
                        raise RuntimeError(
                            f"spawned ranks did not finish within "
                            f"{whole} s or exited without reporting: {dead}"
                        ) from None
                    continue
                reported.add(r)
                if not ok:
                    failures.append(f"rank {r}:\n{payload}")
                    break
                if r == 0:
                    out = torch.load(io.BytesIO(payload), weights_only=False)
            else:
                done = True
        finally:
            restore()
            # after a failure the other ranks may wait in a collective:
            # end them at once
            for p in procs:
                p.join(timeout=10.0 if done else 0.0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
        if failures:
            raise RuntimeError("a spawned rank failed:\n" + "\n".join(failures))
    return out

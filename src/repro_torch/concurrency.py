"""Thread-affinity markers.

Copy of `repro.concurrency` for the port. `MicroBatchScheduler` is
single-threaded by contract: exactly one driver thread may touch it, and
async (event-loop) code must go through a frontend's inbox instead.
`@driver_thread_only` makes that machine-checkable — the
`driver-thread-affinity` rule of the repository's static analysis flags
any call to a marked method from inside an `async def`.

The decorator is a pure marker (returns `fn` unchanged, zero runtime
cost on the hot tick/submit path); the contract is enforced
statically, not dynamically.
"""

from __future__ import annotations


def driver_thread_only(fn):
    """Mark `fn` as callable only from the owning driver thread (or
    whatever single thread owns the object outside a frontend)."""
    fn.__driver_thread_only__ = True
    return fn

"""Fault tolerance: retrying step loop + straggler watchdog (port of
`repro.train.fault`).

The recovery unit is the *job step*:
  1. every step is deterministic given (checkpoint, step index) — the
     data pipeline addresses batches by step (`data.iegm.IEGMStream.
     batch_at`, keyed by (seed, host_id, step));
  2. on failure, reload the latest checkpoint and replay from there
     (`run_training` below does exactly this, with bounded retries);
  3. the straggler watchdog tracks per-step wall time; steps exceeding
     `threshold x median` are flagged.

A step's wall time includes the card's work: `run_training` waits for
the step's metrics inside the `train/step` span, as the reference blocks
on them, so the watchdog and `train.step_latency_s` see the device time
and not only the host's dispatch.

`FaultInjector` provides deterministic failures for the tests.
"""

from __future__ import annotations

import dataclasses
import logging
import statistics
import time
from typing import Any, Callable, Optional

from repro_torch import _device, obs
from repro_torch.train import checkpoint as ckpt

logger = logging.getLogger("repro_torch.fault")


class FaultInjector:
    """Raises RuntimeError on the given (1-based occurrence) step calls."""

    def __init__(self, fail_at: set[int]):
        self.fail_at = set(fail_at)
        self.calls = 0
        self.failures = 0

    def __call__(self, step: int) -> None:
        self.calls += 1
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.failures += 1
            raise RuntimeError(f"injected fault at step {step}")


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than `threshold` x running median."""

    threshold: float = 3.0
    window: int = 50
    times: list = dataclasses.field(default_factory=list)
    flagged: list = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) >= 5:
            med = statistics.median(self.times)
            if dt > self.threshold * med:
                self.flagged.append((step, dt, med))
                logger.warning(
                    "straggler: step %d took %.3fs (median %.3fs)",
                    step, dt, med,
                )
                return True
        return False


def run_training(
    train_step: Callable[[Any, Any], tuple[Any, dict]],
    state: Any,
    batch_at: Callable[[int], Any],
    *,
    num_steps: int,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    keep: int = 3,
    max_retries: int = 3,
    fault_hook: Optional[Callable[[int], None]] = None,
    watchdog: Optional[StragglerWatchdog] = None,
    log_every: int = 10,
    metrics_cb: Optional[Callable[[int, dict], None]] = None,
    restore_device: _device.DeviceLike = None,
    restore_shardings: Any = None,
) -> tuple[Any, list[dict]]:
    """Checkpoint-restart training loop.

    Deterministic replay contract: `batch_at(step)` must return the same
    batch for the same step on every host/retry. Returns (final_state,
    metric history).

    A restored state's leaves go to the devices of `state`'s leaves, or
    to `restore_device` where given. `restore_shardings` (the multi-pod
    step's `NamedSharding`s, mirroring `state`) makes every checkpoint a
    collective one: `checkpoint.save` gathers the per-pod error blocks
    into the reference's layout and rank 0 writes; `restore` gives each
    rank its block back. Every rank runs this loop with the same
    arguments: a `fault_hook` then fires on every rank at the same step,
    and all of them restore together (a rank raising alone would leave
    the others waiting in the step's next collective until the group's
    timeout).

    A donated step (`trainer.make_train_step(..., donate=True)`) writes
    its update into `state` in place, so after a step that raised the
    state is not valid: with `ckpt_dir` the retry restores it from the
    newest checkpoint, as the reference must after its donated step. A
    `fault_hook` raises before the step, with the state intact.
    """
    step = 0
    if ckpt_dir is not None:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            state, step = ckpt.restore(
                ckpt_dir, state, step=latest, device=restore_device,
                shardings=restore_shardings,
            )
            logger.info("resumed from checkpoint step %d", step)

    history: list[dict] = []
    retries = 0
    tel = obs.get()
    step_hist = tel.registry.histogram("train.step_latency_s")
    while step < num_steps:
        t0 = time.monotonic()
        try:
            if fault_hook is not None:
                fault_hook(step)
            batch = batch_at(step)
            with tel.span("train/step", cat="train", step=step):
                state, metrics = train_step(state, batch)
                obs.synchronize(list(metrics.values()))
        except Exception as e:  # noqa: BLE001 — the recovery path
            retries += 1
            tel.registry.counter("train.retries_total").inc()
            logger.warning("step %d failed (%s); retry %d/%d",
                           step, e, retries, max_retries)
            if retries > max_retries:
                raise
            if ckpt_dir is not None:
                latest = ckpt.latest_step(ckpt_dir)
                if latest is not None:
                    state, step = ckpt.restore(
                        ckpt_dir, state, step=latest, device=restore_device,
                        shardings=restore_shardings,
                    )
            continue
        retries = 0
        dt = time.monotonic() - t0
        step_hist.observe(dt)
        tel.registry.counter("train.steps_total").inc()
        if watchdog is not None:
            watchdog.record(step, dt)
        m = {k: float(v) for k, v in metrics.items()}
        m["step"] = step
        m["wall_s"] = dt
        history.append(m)
        if metrics_cb is not None:
            metrics_cb(step, m)
        if log_every and step % log_every == 0:
            logger.info("step %d: %s", step, m)
        step += 1
        if ckpt_dir is not None and step % ckpt_every == 0:
            ckpt.save(state, ckpt_dir, step, keep=keep,
                      shardings=restore_shardings)
    if ckpt_dir is not None:
        ckpt.save(state, ckpt_dir, step, keep=keep,
                  shardings=restore_shardings)
    return state, history

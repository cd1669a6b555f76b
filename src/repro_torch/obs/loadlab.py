"""Open-loop load lab, first piece: arrival schedules and engine warm-up.

Port of the parts of `repro.obs.loadlab` that the serving frontend's
clients and server need (`launch.serve --connect`, `launch.stream
--connect`, `Frontend.warm`). The sweeps, knee location, SLO burn and the
HTML report are ROADMAP.md queue 1 item 9.

Arrival schedules are generated up front, so every request has an
*intended* arrival time before the system under test runs: latency is
measured from it, never from when the load generator got around to
sending (coordinated omission). They are bitwise deterministic in
(seed, uid, rate, n, process, template). The port cannot reproduce
`jax.random` (threefry): where the reference draws on
`fold_in(key, uid)`, a schedule here draws from numpy's generator seeded
by `SeedSequence([seed, uid])` — the same keying discipline (one stream
per (seed, uid), never shared with signal content), not the same
numbers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

ARRIVAL_PROCESSES = ("poisson", "trace")

# default trace-driven interarrival template: a bursty diurnal-ish
# pattern (mean 1 by construction after normalization) — callers pass
# their own recorded gaps for real trace replay
DEFAULT_TRACE_TEMPLATE = (
    0.2, 0.15, 0.3, 2.5, 0.2, 0.25, 1.8, 0.2, 0.3, 0.2, 3.0, 0.9,
)


def interarrival_gaps(
    seed: int,
    uid: int,
    *,
    rate_hz: float,
    n: int,
    process: str = "poisson",
    template: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """(n,) interarrival gaps in seconds with mean 1/rate_hz.

    `poisson` draws exponential gaps (float32, as the reference) from the
    (seed, uid) stream. `trace` replays `template` (normalized to mean 1,
    scaled to the rate) from a cyclic offset drawn from that stream, so
    different uids replay the same empirical shape out of phase.
    """
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be positive, got {rate_hz}")
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), int(uid)]))
    if process == "poisson":
        gaps = rng.standard_exponential(n, dtype=np.float32)
        return gaps.astype(np.float64) / rate_hz
    if process == "trace":
        tpl = np.asarray(
            template if template is not None else DEFAULT_TRACE_TEMPLATE,
            np.float64,
        )
        if tpl.size == 0 or (tpl <= 0).any():
            raise ValueError("trace template must be positive gaps")
        tpl = tpl / tpl.mean()  # mean-1 shape; rate sets the scale
        offset = int(rng.integers(0, tpl.size))
        idx = (offset + np.arange(n)) % tpl.size
        return tpl[idx] / rate_hz
    raise ValueError(
        f"unknown arrival process {process!r} "
        f"(want one of {ARRIVAL_PROCESSES})"
    )


def arrival_times(
    seed: int,
    uid: int,
    *,
    rate_hz: float,
    n: int,
    process: str = "poisson",
    template: Optional[Sequence[float]] = None,
    start_s: float = 0.0,
) -> np.ndarray:
    """(n,) intended absolute arrival times (cumsum of the gaps)."""
    return start_s + np.cumsum(
        interarrival_gaps(
            seed, uid, rate_hz=rate_hz, n=n,
            process=process, template=template,
        )
    )


def warm_engine(eng, prompt_len: int, *, vocab: int = 8) -> None:
    """Pay the first uses an open-loop point can hit before its clock
    starts — kernel builds, library handles, allocator growth — so they
    land outside every request's latency. The reference runs an admission
    group of every width 1..pool, because each width retraces its jitted
    prefill and seat cells; the port traces nothing per shape, so one
    group of the pool's width (the largest prefill, seat and pool decode)
    covers them, and on an engine that chunks `prompt_len`-token prompts,
    one such request covers the chunk cell."""
    import torch

    from repro_torch.serve.engine import Request

    chunk = eng.chunk_tokens
    short = prompt_len if chunk is None else min(prompt_len, chunk)
    lens = [short] * eng.batch + ([prompt_len] if short < prompt_len else [])
    for i, n in enumerate(lens):
        uid = 1_000_000 + i  # out of the clients' uid range
        eng.submit(Request(
            uid=uid,
            prompt=torch.full((n,), uid % vocab, dtype=torch.long),
            # 2 tokens: the first comes from prefill at admission, so the
            # request must survive into a slot to reach the seat and the
            # pool decode
            max_new=2,
        ))
    eng.run()

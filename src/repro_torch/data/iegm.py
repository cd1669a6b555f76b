"""Synthetic IEGM data matching the paper's acquisition spec.

Port of `repro.data.iegm`: the 15–55 Hz FIR band-pass (the same numpy
taps), the synthetic batches, drawn from a `torch.Generator`,
`IEGMStream`, the deterministic host-shardable stream of training
batches, and the per-patient segment streams of the monitoring fleet
(`patient_labels`, `segment_batch`, `stream_segments`). A generator
gives other numbers than the reference's jax PRNG for the same seed, so
tests that compare the two packages feed both the same arrays; the
port's own draws are checked for shape, finiteness and per-seed
determinism.

Classes: 0 non-VA (normal sinus rhythm, 60–100 bpm discrete beats),
1 VA (monomorphic VT at 150–250 bpm, or disorganized VF), plus white
noise and baseline wander. 512 samples @ 250 Hz, normalized per record.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import _device

SAMPLE_RATE_HZ = 250.0
RECORD_LEN = 512
BAND_LO_HZ = 15.0
BAND_HI_HZ = 55.0
VOTE_SEGMENTS = 6


def bandpass_taps(
    num_taps: int = 101,
    lo_hz: float = BAND_LO_HZ,
    hi_hz: float = BAND_HI_HZ,
    fs: float = SAMPLE_RATE_HZ,
) -> np.ndarray:
    """Linear-phase FIR band-pass taps (difference of windowed-sinc
    low-passes, Hamming window)."""
    if num_taps % 2 != 1:
        raise ValueError("odd taps for zero-phase-delay symmetry")
    m = np.arange(num_taps) - (num_taps - 1) / 2

    def lp(fc):
        h = np.sinc(2 * fc / fs * m) * (2 * fc / fs)
        return h * np.hamming(num_taps)

    return (lp(hi_hz) - lp(lo_hz)).astype(np.float32)


_TAPS = torch.from_numpy(bandpass_taps())


def bandpass(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T) zero-padded 'same' FIR filtering, in full
    float32 (no TF32 on the card)."""
    lead, t = x.shape[:-1], x.shape[-1]
    taps = _TAPS.to(device=x.device, dtype=x.dtype).reshape(1, 1, -1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv1d(x.reshape(-1, 1, t), taps, padding=taps.shape[-1] // 2)
    return y.reshape(*lead, t)


def filter_response_db(freq_hz: np.ndarray) -> np.ndarray:
    """|H(f)| in dB for test assertions on the pass/stop bands."""
    taps = bandpass_taps()
    w = 2j * np.pi * freq_hz[:, None] / SAMPLE_RATE_HZ
    h = np.exp(-w * np.arange(len(taps))[None, :]) @ taps
    return 20 * np.log10(np.maximum(np.abs(h), 1e-12))


# ---------------------------------------------------------------------------
# Morphology synthesis
# ---------------------------------------------------------------------------


class _Draw:
    """Draws from `generator` on its own device, results on `device`."""

    def __init__(self, generator: torch.Generator, device: torch.device):
        self.g = generator
        self.device = device

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(shape, generator=self.g, device=self.g.device)
        return (u * (hi - lo) + lo).to(self.device)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.g, device=self.g.device).to(
            self.device
        )

    def bernoulli(self, shape, p: float = 0.5) -> torch.Tensor:
        u = torch.rand(shape, generator=self.g, device=self.g.device)
        return (u < p).to(self.device)

    def times(self) -> torch.Tensor:
        return (
            torch.arange(RECORD_LEN, dtype=torch.float32, device=self.device)
            / SAMPLE_RATE_HZ
        )


def _nsr(d: _Draw, n: int) -> torch.Tensor:
    """Normal sinus rhythm: sharp biphasic beats at 60–100 bpm."""
    t = d.times()
    bpm = d.uniform((n, 1), 60.0, 100.0)
    phase = d.uniform((n, 1), 0.0, 1.0)
    beat_phase = (t[None, :] * bpm / 60.0 + phase) % 1.0
    width = d.uniform((n, 1), 0.012, 0.022)
    z = (beat_phase - 0.5) / width
    amp = d.uniform((n, 1), 0.8, 1.4)
    return amp * (-z * torch.exp(-0.5 * z * z))


def _vt(d: _Draw, n: int) -> torch.Tensor:
    """Monomorphic VT: fast (150–250 bpm) wide-complex oscillation."""
    t = d.times()
    f = d.uniform((n, 1), 150.0, 250.0) / 60.0
    phase = d.uniform((n, 1), 0.0, 1.0)
    amp = d.uniform((n, 1), 0.9, 1.5)
    arg = f * t[None, :] + phase
    return amp * (
        torch.sin(2 * math.pi * arg) + 0.45 * torch.sin(4 * math.pi * arg)
    )


def _vf(d: _Draw, n: int) -> torch.Tensor:
    """VF: disorganized — three drifting 3–8 Hz components."""
    t = d.times()
    out = torch.zeros((n, RECORD_LEN), device=d.device)
    for _ in range(3):
        f0 = d.uniform((n, 1), 3.0, 8.0)
        drift = torch.cumsum(d.normal((n, RECORD_LEN)) * 0.4, dim=1)
        amp = d.uniform((n, 1), 0.3, 0.8)
        out = out + amp * torch.sin(
            2 * math.pi * (f0 * t[None, :] + drift / SAMPLE_RATE_HZ)
        )
    return out


def _noise(d: _Draw, n: int) -> torch.Tensor:
    """White noise plus respiration-rate baseline wander."""
    t = d.times()
    white = d.normal((n, RECORD_LEN)) * 0.08
    wander_f = d.uniform((n, 1), 0.15, 0.45)
    return white + 0.6 * torch.sin(2 * math.pi * wander_f * t[None, :])


def _signals(d: _Draw, labels: torch.Tensor, filtered: bool) -> torch.Tensor:
    """One record per label: NSR for 0, VT or VF (even odds) for 1, plus
    noise; band-passed and normalized per record (front-end AGC)."""
    n = labels.shape[0]
    nsr, vt, vf = _nsr(d, n), _vt(d, n), _vf(d, n)
    va = torch.where(d.bernoulli((n, 1)), vf, vt)
    sig = torch.where(labels[:, None] == 1, va, nsr) + _noise(d, n)
    if filtered:
        sig = bandpass(sig)
    sig = sig / (torch.std(sig, dim=1, keepdim=True, correction=0) + 1e-6)
    return sig.to(torch.float32)


def synth_batch(
    generator: torch.Generator,
    batch: int,
    *,
    filtered: bool = True,
    device: _device.DeviceLike = None,
) -> dict[str, torch.Tensor]:
    """Balanced batch of {signal (B, 512) f32, label (B,) i32}."""
    d = _Draw(generator, _device.resolve(device))
    labels = d.bernoulli((batch,)).to(torch.int32)
    return {"signal": _signals(d, labels, filtered), "label": labels}


def synth_diagnosis_batch(
    generator: torch.Generator,
    batch: int,
    *,
    segments: int = VOTE_SEGMENTS,
    device: _device.DeviceLike = None,
) -> dict[str, torch.Tensor]:
    """Per-patient batches of `segments` recordings sharing one diagnosis:
    {signal (B, segments, 512) f32, label (B,) i32}."""
    d = _Draw(generator, _device.resolve(device))
    labels = d.bernoulli((batch,)).to(torch.int32)
    sig = _signals(d, labels.repeat_interleave(segments), True)
    return {"signal": sig.reshape(batch, segments, RECORD_LEN), "label": labels}


def _stream_seed(seed: int, stream: int, index: int) -> int:
    """A 63-bit generator seed from (seed, host_id, step) or (seed,
    patient, seq), spread by numpy's SeedSequence so neighbouring triples
    draw unrelated streams."""
    state = np.random.SeedSequence([seed, stream, index]).generate_state(
        1, np.uint64
    )
    return int(state[0]) >> 1


# ---------------------------------------------------------------------------
# Per-patient deterministic segment streams (the fleet-monitoring feed)
# ---------------------------------------------------------------------------

# Keys the per-patient *condition* draw apart from the per-segment draws:
# a segment is keyed (seed, patient, seq), the label (seed, patient,
# _LABEL_FOLD), so the constant must sit outside any reachable seq (seqs
# are segment counters).
_LABEL_FOLD = 0x7FFFFFFF


def patient_labels(
    seed: int, patient_ids, va_fraction: float = 0.5
) -> torch.Tensor:
    """Persistent per-patient condition (0 non-VA / 1 VA), int32 (B,) on
    the CPU: one uniform draw per patient from SeedSequence([seed,
    patient, _LABEL_FOLD]), VA below `va_fraction`, so every view of the
    fleet (sources, tests, benchmarks) agrees on the ground truth."""
    pids = np.asarray(patient_ids, np.int64).ravel()
    draws = [_label_draw(seed, p) for p in pids.tolist()]
    return torch.as_tensor(np.asarray(draws) < va_fraction, dtype=torch.int32)


# A fleet is often simulated again over the same (patient, seq) rows — a
# benchmark's repeated runs, one path against another — so the per-row
# draws are memoized (up to 16384 rows, 32 MiB of float32 on the CPU):
# a row costs about a millisecond of host time to draw, a hit a fraction
# of a microsecond. The cache holds values that the arguments determine
# bit for bit; callers get copies (`torch.cat`).
_ROW_CACHE = 1 << 14


@functools.lru_cache(maxsize=_ROW_CACHE)
def _label_draw(seed: int, patient: int) -> float:
    """The patient's condition draw, from SeedSequence([seed, patient,
    _LABEL_FOLD])."""
    return np.random.default_rng([seed, patient, _LABEL_FOLD]).random()


@functools.lru_cache(maxsize=_ROW_CACHE)
def _segment_row(
    seed: int, patient: int, seq: int, label: int, device: torch.device
) -> torch.Tensor:
    """One (1, 512) record of `label`, drawn, band-passed and normalized
    on its own from a generator seeded by (seed, patient, seq)."""
    gen = torch.Generator().manual_seed(_stream_seed(seed, patient, seq))
    labels = torch.tensor([label], dtype=torch.int32, device=device)
    return _signals(_Draw(gen, device), labels, True)


def segment_batch(
    seed: int,
    patient_ids,
    seqs,
    *,
    va_fraction: float = 0.5,
    device: _device.DeviceLike = None,
) -> dict[str, torch.Tensor]:
    """Batched deterministic segments for (patient, seq) pairs:
    {signal (B, 512) f32, label (B,) i32} on `device`.

    Every row is drawn, band-passed and normalized on its own, from a
    generator seeded by (seed, patient, seq), so the same triple
    regenerates a bit-identical row whatever the batch's composition or
    order (rows are memoized: `_segment_row`); the label is the
    patient's persistent `patient_labels` draw.
    The reference keys rows with jax's threefry `fold_in`, which torch
    cannot reproduce: the rows hold the same properties, not the same
    numbers."""
    dev = _device.resolve(device)
    pids = np.asarray(patient_ids, np.int64).ravel()
    sqs = np.asarray(seqs, np.int64).ravel()
    if pids.shape != sqs.shape:
        raise ValueError(f"{pids.shape[0]} patients for {sqs.shape[0]} seqs")
    labels = patient_labels(seed, pids, va_fraction)
    rows = [
        _segment_row(seed, p, s, y, dev)
        for p, s, y in zip(pids.tolist(), sqs.tolist(), labels.tolist())
    ]
    signal = (
        torch.cat(rows) if rows
        else torch.zeros((0, RECORD_LEN), dtype=torch.float32, device=dev)
    )
    return {"signal": signal, "label": labels.to(dev)}


def stream_segments(
    patient_id: int,
    *,
    seed: int = 0,
    start: int = 0,
    va_fraction: float = 0.5,
    device: _device.DeviceLike = None,
) -> Iterator[dict]:
    """Infinite per-patient segment iterator (the device's view of one
    implant's telemetry). Deterministic: two iterators for the same
    (seed, patient_id) yield identical segments; restarting at `start=k`
    regenerates segment k exactly."""
    seq = start
    while True:
        out = segment_batch(
            seed, [patient_id], [seq], va_fraction=va_fraction, device=device
        )
        yield {"signal": out["signal"][0], "label": int(out["label"][0]),
               "seq": seq}
        seq += 1


@dataclasses.dataclass
class IEGMStream:
    """Deterministic, host-shardable stream of training batches.

    `batch_at(step)` seeds a fresh generator on the stream's device from
    (seed, host_id, step) and draws the batch there: a restart at step k
    regenerates the identical batch (the checkpoint/restart contract), and
    every host draws its own. `device=None` means the CUDA card; the
    stream raises at construction when there is none.
    """

    batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    device: _device.DeviceLike = None

    def __post_init__(self):
        self.device = _device.resolve(self.device)

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_stream_seed(self.seed, self.host_id, step))
        return synth_batch(gen, self.batch, device=self.device)

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

"""Synthetic IEGM data matching the paper's acquisition spec.

Port of the slice of `repro.data.iegm` the diagnosis service needs:
the 15–55 Hz FIR band-pass (the same numpy taps) and the synthetic
batches, drawn from a `torch.Generator`. A generator gives other numbers
than the reference's jax PRNG for the same seed, so tests that compare
the two packages feed both the same arrays; the port's own draws are
checked for shape, finiteness and per-seed determinism.

Classes: 0 non-VA (normal sinus rhythm, 60–100 bpm discrete beats),
1 VA (monomorphic VT at 150–250 bpm, or disorganized VF), plus white
noise and baseline wander. 512 samples @ 250 Hz, normalized per record.
"""

from __future__ import annotations

import math

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

"""Vectorized per-patient 6-segment majority-vote state machines.

Port of `repro.stream.vote`. The paper's diagnosis protocol (and
`core.vadetect.vote`): every 6 consecutive segment classifications of
one patient are aggregated by majority vote, ties breaking toward VA. A
fleet of P patients is P concurrent state machines held as three int32
tensors on the runner's device — a (P, 6) prediction ring, a (P,)
processed-segment counter, and a (P,) last-positive counter — and one
scatter `update` advances every machine touched by a packed batch at
once. Diagnosis emission is itself batched: the update returns a (P,)
emission mask plus the voted diagnoses.

Duplicate patients within one batch are handled exactly: each row's
ring slot is its patient's counter *plus the row's rank among same-
patient rows in the batch*, so a backlogged patient draining several
segments through one bucket still fills consecutive slots. The scatter
addresses (count + rank) % 6 and the vote fires once at end of batch,
so one update's rows for a patient must stay inside one vote window —
rows crossing a 6-boundary would overwrite pre-boundary slots before
they are voted on. The scheduler enforces exactly that alignment at
pack time (`next_batch` caps each patient at the remaining slots of
its current window).

The reference scatters with `mode="drop"`, sending padding rows out of
range. PyTorch has no drop mode, so the scatters here act on the valid
rows only, without a boolean gather (which would wait for the device):
padding rows write the ring's scratch slot past its end, add 0 to the
counter and take the max with `_NEG` for `last_positive`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import _device
from repro_torch.core import vadetect

VOTE_SEGMENTS = vadetect.VOTE_SEGMENTS  # 6
URGENT_WINDOW = VOTE_SEGMENTS  # a positive keeps a patient hot for one vote

_NEG = -(2**30)  # "never" sentinel for last_positive


class VoteState(NamedTuple):
    ring: torch.Tensor  # (P, 6) int32 — last 6 segment predictions
    count: torch.Tensor  # (P,) int32 — processed segments per patient
    last_positive: torch.Tensor  # (P,) int32 — count at last VA-positive


def init(n_patients: int, *, device: _device.DeviceLike = None) -> VoteState:
    """Fresh machines on `device` (`None` means the CUDA card)."""
    dev = _device.resolve(device)
    return VoteState(
        ring=torch.zeros((n_patients, VOTE_SEGMENTS), dtype=torch.int32,
                         device=dev),
        count=torch.zeros((n_patients,), dtype=torch.int32, device=dev),
        last_positive=torch.full((n_patients,), _NEG, dtype=torch.int32,
                                 device=dev),
    )


def _dup_rank(patients: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rank of each row among earlier valid rows of the same patient."""
    i = torch.arange(patients.shape[0], device=patients.device)
    same = (patients[:, None] == patients[None, :]) & valid[None, :]
    return torch.sum(same & (i[None, :] < i[:, None]), dim=1,
                     dtype=torch.int32)


def update(
    state: VoteState,
    patients,  # (B,) int — patient of each row
    preds,  # (B,) int — 0 non-VA / 1 VA
    valid,  # (B,) bool — padding mask
) -> tuple[VoteState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance the touched state machines by one packed batch (inputs are
    moved to the state's device; the state is not modified in place).

    Returns (new_state, emit (P,) bool, diagnosis (P,) i32, urgent (P,)
    bool): `emit[p]` is set when patient p's counter crossed a multiple
    of 6 in this batch, `diagnosis[p]` is the majority vote over its
    ring at that point, and `urgent[p]` flags patients whose last
    positive segment is within the preceding vote window (the
    scheduler's preemption bitmap).
    """
    dev = state.ring.device
    n_patients = state.ring.shape[0]
    patients = torch.as_tensor(patients, device=dev).to(torch.int64)
    preds = torch.as_tensor(preds, device=dev).to(torch.int32)
    valid = torch.as_tensor(valid, device=dev).to(torch.bool)
    rank = _dup_rank(patients, valid)
    # read before the scatters, as the reference does
    base = state.count[patients] + rank
    slot = base % VOTE_SEGMENTS
    # the ring, flattened with one scratch slot past its end that every
    # padding row writes (valid rows never share a slot: their ranks
    # differ and the scheduler keeps them inside one window)
    flat = torch.cat(
        (state.ring.reshape(-1), state.ring.new_zeros(1))
    )
    target = torch.where(valid, patients * VOTE_SEGMENTS + slot,
                         n_patients * VOTE_SEGMENTS)
    flat.index_put_((target,), preds)
    ring = flat[:-1].view(n_patients, VOTE_SEGMENTS)
    # duplicate patients add up; padding rows add 0
    count = state.count.index_add(0, patients, valid.to(torch.int32))
    # position (1-based counter value) of each row; positives advance
    # last_positive via scatter-max, duplicates resolved by max
    row_pos = base + 1
    pos_val = torch.where(valid & (preds == 1), row_pos,
                          torch.full_like(row_pos, _NEG))
    last_positive = state.last_positive.scatter_reduce(
        0, patients, pos_val, "amax", include_self=True
    )
    emit = (count // VOTE_SEGMENTS) > (state.count // VOTE_SEGMENTS)
    diagnosis = vadetect.vote(ring)
    urgent = (count - last_positive) < URGENT_WINDOW
    return (
        VoteState(ring=ring, count=count, last_positive=last_positive),
        emit,
        diagnosis,
        urgent,
    )

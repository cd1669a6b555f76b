"""Collective bytes and the roofline terms of one step (port of
`repro.launch.hlo_analysis`).

The reference parses the optimized HLO for its collectives. An eager
program issues its own, so the port counts them where they are handed to
`torch.distributed`: `dist.sharding.comm_calls` / `comm_bytes` (the
layers' and the trainer's collectives) and `dist.compression.wire_calls`
/ `wire_bytes` (the cross-pod reductions), under the reference's kind
names. No `collective-permute` or `all-to-all` appears unless the program
calls one: XLA inserts those when it reshards, and an eager program never
does, so collective counts do not compare across the two packages.

Byte convention (per device, per executed step): an operand's bytes, as
the reference assigns them,

  all-reduce          the tensor reduced           (= result bytes)
  all-gather          this rank's block            (= result / group)
  reduce-scatter      the whole tensor             (= result * group)
  all-to-all          the tensor sent              (= result bytes)

with the ring factors left to the roofline, as there.

The roofline terms are the reference's, term for term, at one NVIDIA
H100 SXM's data-sheet figures in place of the TPU v5e's: 989e12 FLOP/s
dense bf16, 3.35e12 B/s of HBM, and 450e9 B/s each way over NVLink. The
last holds between the cards of one host (eight, all to all over
NVSwitch); a 16-wide mesh axis spans two hosts, whose traffic crosses the
slower network between them, so the collective term is optimistic there.
The seconds are modelled, not measured.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: dict
    count_by_op: dict
    total_bytes: int

    def to_dict(self) -> dict:
        return {
            "bytes_by_op": dict(self.bytes_by_op),
            "count_by_op": dict(self.count_by_op),
            "total_bytes": int(self.total_bytes),
        }


def collective_stats(calls: dict, nbytes: dict) -> CollectiveStats:
    """The stats of one call's collectives: its calls and operand bytes by
    kind, as `obs.torchprobe.CallRecord` counts them (`collectives`,
    `collective_bytes`; `torchprobe.comm_snapshot` is the running
    total)."""
    count_by_op = {k: int(v) for k, v in calls.items() if v}
    bytes_by_op = {k: int(nbytes.get(k, 0)) for k in count_by_op}
    return CollectiveStats(bytes_by_op=bytes_by_op, count_by_op=count_by_op,
                           total_bytes=sum(bytes_by_op.values()))


# ---------------------------------------------------------------------------
# Roofline terms (NVIDIA H100 SXM data-sheet figures, one card)
# ---------------------------------------------------------------------------

PEAK_FLOPS_BF16 = 989e12  # FLOP/s per card, dense
HBM_BW = 3.35e12  # B/s per card
NVLINK_BW = 450e9  # B/s each way per card, inside one host


def roofline_terms(
    *,
    per_device_flops: float,
    per_device_bytes: float,
    per_device_collective_bytes: float,
    model_flops_total: float,
    n_devices: int,
    per_device_arg_bytes: float = 0.0,
) -> dict:
    """The three roofline terms in seconds (per step, per device — every
    rank runs the same program on its block, so per-device == critical
    path under perfect overlap).

    roofline_fraction = ideal time / binding term, where ideal is the
    LARGER of (a) useful MODEL_FLOPS at peak and (b) reading every live
    input byte (params + caches) exactly once at HBM bandwidth — (b) is
    the honest floor for memory-bound decode, where MODEL_FLOPS alone
    would make any KV-dominated step look like 0."""
    t_compute = per_device_flops / PEAK_FLOPS_BF16
    t_memory = per_device_bytes / HBM_BW
    t_coll = per_device_collective_bytes / NVLINK_BW
    dominant = max(
        ("compute", t_compute), ("memory", t_memory),
        ("collective", t_coll), key=lambda kv: kv[1],
    )[0]
    bound = max(t_compute, t_memory, t_coll)
    useful = model_flops_total / max(per_device_flops * n_devices, 1.0)
    t_useful = (model_flops_total / n_devices) / PEAK_FLOPS_BF16
    t_ideal = max(t_useful, per_device_arg_bytes / HBM_BW)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": bound,
        "model_flops_total": model_flops_total,
        "hlo_flops_total": per_device_flops * n_devices,
        "useful_flops_ratio": useful,
        "t_ideal_s": t_ideal,
        "roofline_fraction": (t_ideal / bound) if bound > 0 else 0.0,
    }

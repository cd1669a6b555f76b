"""Streaming fleet quickstart: 1k synthetic patients on one card.

    python -m repro_torch.examples.stream_fleet [--path twin|kernel]

Port of `examples/stream_fleet.py` on one device in place of the 8-device
data mesh. Compiles the paper's VA detector (random weights from seed 0)
into the chip program and drives a 1000-patient monitoring fleet through
`repro_torch.stream`: per-patient 250 Hz IEGM streams with arrival
jitter, deadline-aware micro-batching into fixed bucket shapes, inference
on the card (`path="kernel"` runs the CUDA `nm_spmm`; the default
`"twin"` the decompressed dense convolutions), and batched 6-segment
majority voting. `device=None` means the CUDA card and raises without
one; `main(device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import _device
from repro_torch.core import compiler, vadetect
from repro_torch.stream import FleetConfig, simulate


def fleet_config(path: str = "twin", patients: int = 1000) -> FleetConfig:
    """The example's fleet: 6 segments (one vote window) per patient, 5%
    VA patients, 5% arrival jitter, buckets (32, 128, 512)."""
    return FleetConfig(
        n_patients=patients,
        segments_per_patient=6,  # one full vote window per patient
        va_fraction=0.05,
        jitter_frac=0.05,
        buckets=(32, 128, 512),
        path=path,
    )


def build_program(device: _device.DeviceLike = None):
    """The paper's detector with random weights from seed 0, compiled
    into the chip program on `device`."""
    dev = _device.resolve(device)
    params = vadetect.init(torch.Generator().manual_seed(0), device=dev)
    return compiler.compile_model(params)


def run(
    device: _device.DeviceLike = None, path: str = "twin",
    patients: int = 1000,
) -> dict:
    """Compile the detector and simulate the fleet; `simulate`'s result."""
    dev = _device.resolve(device)
    return simulate(fleet_config(path, patients), build_program(dev), device=dev)


def main(
    device: _device.DeviceLike = None, path: str = "twin",
    patients: int = 1000,
) -> dict:
    out = run(device, path, patients)
    m, rt, chip = out["metrics"], out["realtime"], out["chip"]
    print(
        f"fleet: {patients} patients, "
        f"{m['segments_total']} segments in {m['batches_total']} "
        f"batches (pad {m['pad_fraction']:.1%}), dropped="
        f"{m['dropped_total']}, path={path}"
    )
    print(
        f"throughput: {m['segments_per_s_wall']:.0f} seg/s wall = "
        f"{rt['realtime_factor']:.1f}x real-time; modeled 1-chip fleet "
        f"{chip['modeled_fleet_segments_per_s']:.0f} seg/s (perf model)"
    )
    sl = m.get("deadline_slack_s")
    if sl:
        print(
            f"deadline slack: p50={sl['p50']*1e3:.0f}ms "
            f"worst-1%={sl['worst_1pct']*1e3:.0f}ms "
            f"violations={sl['violations']}"
        )
    print(
        f"diagnoses: {m['diagnoses_total']} "
        f"(VA={m['va_diagnoses_total']}), synthetic diagnostic "
        f"accuracy {out['accuracy']['diagnostic_accuracy_synthetic']:.3f} "
        f"(untrained weights)"
    )
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--path", default="twin",
                    choices=("twin", "kernel", "reference", "dense"))
    args = ap.parse_args()
    main(path=args.path)

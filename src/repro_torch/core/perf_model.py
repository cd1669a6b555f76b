"""Analytic cycle/energy/power model of the fabricated chip.

A copy of `repro.core.perf_model`, which is pure Python; the port keeps
its own so that it never imports `repro` (whose package import loads
jax). The two must agree field by field (tests/test_torch_core.py).

We obviously cannot re-measure the TSMC 40 nm silicon; what we *can* do —
and what this module does — is model the published architecture faithfully
enough that the paper's own measured numbers (150 GOPS, 35 µs/inference,
10.60 µW average power, 0.57 µW/mm²) fall out of the model at the paper's
operating point, and then use the same model to predict the other operating
points the chip supports (4/2/1-bit layers, dense vs sparse) for the
ablation benchmarks.

Architecture constants (all from the paper):
  * 4-D array N×W×H×M = 2×4×4×16 = 512 PEs; 12 PE + 4 MPE per SPE.
  * 1-D demo engages 1 of 4 computing cores with N padded to 4 → 128 PEs.
  * 400 MHz @ 1.14 V, TSMC 40 nm LP; die 18.63 mm².
  * 50 % balanced sparsity → each PE skips zeros → 2× effective MACs.

Calibrated constants (fit so the model reproduces the measured silicon —
documented as calibration, not measurement):
  * E_MAC_8B: energy of one 8-bit sparse MAC incl. local data movement.
  * P_LEAK: leakage + always-on (SPad, control, clock tree).
  * CMUL energy scales ≈ linearly with weight bit width (bit-serial planes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

# ---------------------------------------------------------------------------
# Chip constants (published)
# ---------------------------------------------------------------------------
FREQ_HZ = 400e6
VOLTAGE = 1.14
DIE_AREA_MM2 = 18.63
ARRAY_N, ARRAY_W, ARRAY_H, ARRAY_M = 2, 4, 4, 16
TOTAL_PES = ARRAY_N * ARRAY_W * ARRAY_H * ARRAY_M  # 512
DEMO_CORES = 1  # of ARRAY_W computing cores engaged in the 1-D demo
DEMO_N_PAD = 4  # input channels padded to 4
DEMO_PES = 128  # paper: "only 128 PEs are engaged"

# ---------------------------------------------------------------------------
# Calibrated constants (fit so the model lands on Table 1's measured row;
# documented as calibration, not measurement)
# ---------------------------------------------------------------------------
# One IEGM recording spans 512 samples @ 250 Hz = 2.048 s; the chip is
# duty-cycled: one 35 us inference per recording window. The paper's
# "10.60 uW average power" is the monitoring average over that window.
RECORD_PERIOD_S = 512 / 250.0
E_MAC_8B_J = 0.2e-12  # J per executed 8-bit MAC incl. SPad movement
P_IDLE_W = 10.48e-6  # retention + always-on front-end + leakage
N_PAR = ARRAY_N  # input channels consumed per cycle per core (N=2)
TILE_OVERHEAD_CYC = 11  # SPad window (re)load + bias + act + writeback


@dataclasses.dataclass(frozen=True)
class LayerWorkload:
    """Static description of one conv/linear layer's work."""

    name: str
    c_in: int
    c_out: int
    ksize: int
    t_out: int
    macs: int  # dense MAC count
    bits: int = 8
    keep_frac: float = 0.5  # kept fraction under balanced pruning
    sparse: bool = True


@dataclasses.dataclass
class LayerReport:
    name: str
    cycles: int
    dense_macs: int
    executed_macs: int
    utilization: float  # executed MACs / (cycles * engaged PEs)


@dataclasses.dataclass
class ChipReport:
    layers: list[LayerReport]
    total_cycles: int
    latency_s: float
    effective_gops: float  # dense-equivalent ops/s (the paper's metric)
    executed_gops: float  # physically-executed ops/s
    energy_j: float
    avg_power_w: float
    power_density_uw_mm2: float
    pe_utilization: float

    def summary(self) -> dict:
        return {
            "latency_us": self.latency_s * 1e6,
            "effective_GOPS": self.effective_gops,
            "executed_GOPS": self.executed_gops,
            "avg_power_uW": self.avg_power_w * 1e6,
            "power_density_uW_mm2": self.power_density_uw_mm2,
            "pe_utilization": self.pe_utilization,
            "total_cycles": self.total_cycles,
        }


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def layer_cycles(
    wl: LayerWorkload, *, engaged_pes: int = DEMO_PES, n_par: int = N_PAR
) -> LayerReport:
    """Blocked-loop cycle model of the SPE array on one layer.

    Dataflow (paper Fig. 1/2): the array computes a W×H×M block of outputs
    in parallel; input channels stream N(=2)-at-a-time through the shared
    SPad; each PE performs one (non-skipped) MAC per cycle; with balanced
    sparsity, pruned weights are skipped for free (that is the point of
    the balanced constraint: all PEs skip in lockstep). Bit width < 8 does
    not change the cycle count on this chip (the CMUL is spatially
    bit-parallel); it changes energy. Each output tile additionally pays
    TILE_OVERHEAD_CYC for the SPad window (re)load, bias, activation and
    writeback — the calibrated constant that lands the model on the
    paper's measured 35 us (see EXPERIMENTS.md §Paper).
    """
    m_tiles = _ceil_div(wl.c_out, ARRAY_M)
    pos_tiles = _ceil_div(wl.t_out, ARRAY_H)
    cin_steps = _ceil_div(wl.c_in, n_par)
    kept = wl.keep_frac if wl.sparse else 1.0
    # kept fraction of the k x c_in contraction survives; balanced pruning
    # guarantees the per-group count is exact, so the cycle count is exact.
    contraction_cycles = max(1, math.ceil(wl.ksize * cin_steps * kept))
    cycles = m_tiles * pos_tiles * (contraction_cycles + TILE_OVERHEAD_CYC)
    executed = int(wl.macs * kept)
    util = executed / max(1, cycles * engaged_pes)
    return LayerReport(
        name=wl.name,
        cycles=int(cycles),
        dense_macs=wl.macs,
        executed_macs=executed,
        utilization=min(1.0, util),
    )


def chip_report(
    layers: Sequence[LayerWorkload],
    *,
    engaged_pes: int = DEMO_PES,
    freq_hz: float = FREQ_HZ,
) -> ChipReport:
    reports = [layer_cycles(wl, engaged_pes=engaged_pes) for wl in layers]
    total_cycles = sum(r.cycles for r in reports)
    latency = total_cycles / freq_hz
    dense_ops = 2 * sum(r.dense_macs for r in reports)  # MAC = 2 ops
    executed_ops = 2 * sum(r.executed_macs for r in reports)
    # energy: per executed MAC, scaled by bit width (bit-serial CMUL
    # planes); the monitoring average duty-cycles one inference per
    # 2.048 s recording window on top of the idle/retention floor.
    energy = 0.0
    for wl, r in zip(layers, reports):
        e_mac = E_MAC_8B_J * (wl.bits / 8.0)
        energy += r.executed_macs * e_mac
    avg_power = P_IDLE_W + energy / RECORD_PERIOD_S
    return ChipReport(
        layers=reports,
        total_cycles=total_cycles,
        latency_s=latency,
        effective_gops=dense_ops / latency / 1e9,
        executed_gops=executed_ops / latency / 1e9,
        energy_j=energy,
        avg_power_w=avg_power,
        power_density_uw_mm2=avg_power * 1e6 / DIE_AREA_MM2,
        pe_utilization=sum(r.executed_macs for r in reports)
        / max(1, total_cycles * engaged_pes),
    )


# Paper Table-1 reference row (measured silicon) for benchmark comparison.
PAPER_MEASURED = {
    "latency_us": 35.0,
    "effective_GOPS": 150.0,
    "avg_power_uW": 10.60,
    "power_density_uW_mm2": 0.57,
    "inference_accuracy": 0.9235,
    "diagnostic_accuracy": 0.9995,
    "precision": 0.9988,
    "recall": 0.9984,
}

PRIOR_WORKS = {
    "TBCAS'19 [4]": {"tech_nm": 180, "power_uW": 13.34, "density": 14.50},
    "ICICM'22 [5]": {"tech_nm": 180, "power_uW": 11.76, "density": 8.11},
    "MWSCAS'22 [3]": {"tech_nm": 40, "power_uW": 5.10, "density": 9.44},
    "ISCAS'24 [2]": {"tech_nm": 40, "power_uW": 12.19, "density": None},
}

"""Paper Table 1 reproduction: chip comparison row from the perf model
(port of `benchmarks/table1.py`).

    python -m repro_torch.benchmarks.table1

The silicon numbers (latency / GOPS / power / power density) are derived
from the analytic chip model (`core.perf_model`) at the paper's operating
point and printed next to the paper's measured row and the prior works.
The model is arithmetic on the host: no tensor is made, so the rows take
no device. The µs column times that arithmetic.
"""

from __future__ import annotations

import time

from repro_torch.core import compiler, perf_model, vadetect


def run() -> list[tuple[str, float, str]]:
    t0 = time.perf_counter()
    r = compiler.chip_report(vadetect.layer_shapes(vadetect.VAConfig()))
    dt_us = (time.perf_counter() - t0) * 1e6
    s = r.summary()
    paper = perf_model.PAPER_MEASURED

    rows = [
        ("table1.latency_us", dt_us,
         f"model={s['latency_us']:.2f} paper={paper['latency_us']}"),
        ("table1.effective_GOPS", dt_us,
         f"model={s['effective_GOPS']:.1f} paper={paper['effective_GOPS']}"),
        ("table1.avg_power_uW", dt_us,
         f"model={s['avg_power_uW']:.2f} paper={paper['avg_power_uW']}"),
        ("table1.power_density_uW_mm2", dt_us,
         f"model={s['power_density_uW_mm2']:.3f} "
         f"paper={paper['power_density_uW_mm2']}"),
    ]
    best_prior = min(
        v["density"] for v in perf_model.PRIOR_WORKS.values()
        if v["density"] is not None
    )
    rows.append((
        "table1.density_improvement_x", dt_us,
        f"model={best_prior / s['power_density_uW_mm2']:.2f} paper=14.23",
    ))
    return rows


def main() -> None:
    for name, us, derived in run():
        print(f"{name},{us:.2f},{derived}")


if __name__ == "__main__":
    main()

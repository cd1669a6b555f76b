#!/usr/bin/env python3
"""Drive the PyTorch port's VA diagnosis path on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an H100 and the CUDA
toolkit. Phases, each printing JSON lines:

1. device — the card (nvidia-smi's name and power limit), then a build of
   every CUDA kernel of the path from src/repro_torch/kernels/csrc;
2. kernel — each kernel against its plain PyTorch version at the shapes
   the path gives it (the seven sparse VA layers at bucket 256) and one
   ragged shape;
3. service — VAService.diagnose_batch and FleetRunner.classify on
   path="kernel" at full width (configs/va_cnn CONFIG, then MIXED), held
   against the reference and twin paths, with the kernel's launches
   counted over that run;
4. time — kernel, plain version, one library call and the bound at each
   layer shape, and the whole execute, on the card.

The line before the last is the {"kernels": [...]} summary, the last
{"ok": true, "device": {...}}. Any failure exits non-zero before either;
so does a host without a CUDA card, or a directory without the port.
Imports nothing of jax and nothing of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
BUCKET = 256  # FleetRunner bucket: M = 256 * T_out per layer
PATIENTS = 4  # VAService: 4 patients x 6 segments
RAGGED = (130, 64, 130)  # (M, K, N): masked edges in both M and N
KERNEL_RTOL = 1e-4  # max|kernel - plain| / max|plain| (f32, tests/test_kernels.py)
LOGITS_TOL = 1e-3  # kernel path vs reference path (tests/test_vadetect.py)
REPS = 25  # timed runs per function; the median is kept
# H100 SXM data sheet: HBM rate, and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def device_ms(torch, fn) -> float:
    """Median device time of `fn` in ms over REPS runs, warm. A sleep
    kernel ahead of each run keeps the card busy while the host enqueues
    the run, so host overhead does not count."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(torch, fn) -> float:
    """Median host time in ms of `fn` through a synchronize, warm."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(m: int, k: int, kk: int, n: int) -> tuple[float, float]:
    """Least times in ms for one nm_spmm: (bytes, operations) — x, values,
    select and scale read once and y written once at the HBM rate, and
    2*M*Kk*N float32 operations at the float32 rate. The bound is the
    larger."""
    nbytes = m * k * 4 + kk * n * 2 + n * 4 + m * n * 4
    ops = 2 * m * kk * n
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3


def layer_problems(cfg, vadetect) -> list[dict]:
    """(M, K, Kk, N) of every sparse layer's nm_spmm at bucket BUCKET."""
    out = []
    for i, m in enumerate(vadetect.layer_shapes(cfg)):
        spe = cfg.layer_spe(i)
        if not (spe and spe.sparse):
            continue
        k = -(-(m["ksize"] * m["c_in"]) // spe.group_size) * spe.group_size
        out.append(dict(layer=m["name"], m=BUCKET * m["t_out"], k=k,
                        kk=k // spe.group_size * spe.keep, n=m["c_out"]))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no src/repro_torch under {ROOT}")
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs import va_cnn
    from repro_torch.core import compiler, spe, vadetect
    from repro_torch.data import iegm
    from repro_torch.kernels import _build
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels._common import decompress_tile
    from repro_torch.serve.va_service import VAService
    from repro_torch.stream.runner import FleetRunner

    # full float32 for every reference matmul (the default; stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    t0 = time.perf_counter()
    built = _build.build((K.NAME,))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": [{"name": b.name, "seconds": b.seconds,
                       "ptxas": [ln.strip() for ln in b.log.splitlines()
                                 if "ptxas info" in ln and ("Used" in ln
                                                            or "spill" in ln)]}
                      for b in built]})

    # -- 2. each kernel against its plain version ---------------------------
    gen_dev = torch.Generator(device=dev).manual_seed(SEED)
    problems = layer_problems(va_cnn.CONFIG, vadetect)
    m_r, k_r, n_r = RAGGED
    shapes = problems + [dict(layer="ragged", m=m_r, k=k_r, kk=k_r // 2, n=n_r)]
    max_abs_err = 0.0
    for p in shapes:
        w = torch.randn((p["k"], p["n"]), generator=gen_dev, device=dev)
        layer = spe.compile_layer(w, spe.SPEConfig())
        x = torch.randn((p["m"], p["k"]), generator=gen_dev, device=dev)
        args = (x, layer.values_q, layer.select, layer.scale)
        y_k = K.nm_spmm_cuda(*args, group_size=16, keep=8)
        torch.cuda.synchronize()
        y_p = K.nm_spmm_plain(*args, group_size=16, keep=8)
        torch.cuda.synchronize()
        err = float((y_k - y_p).abs().max())
        rel = err / max(float(y_p.abs().max()), 1e-30)
        max_abs_err = max(max_abs_err, err)
        emit({"phase": "kernel", "kernel": K.NAME, **p, "max_abs_err": err,
              "rel_err": rel, "tol": KERNEL_RTOL})
        check(tuple(y_k.shape) == (p["m"], p["n"]), f"{p}: shape {tuple(y_k.shape)}")
        check(bool(torch.isfinite(y_k).all()), f"{p}: non-finite output")
        check(rel <= KERNEL_RTOL, f"{p}: kernel vs plain rel err {rel}")

    # -- 3. the service path at full width ----------------------------------
    main_launches = None
    gen = torch.Generator().manual_seed(SEED)  # CPU: same weights anywhere
    timed = None  # the CONFIG program, timed in phase 4
    for cname, cfg in (("CONFIG", va_cnn.CONFIG), ("MIXED", va_cnn.MIXED)):
        params = vadetect.init(gen, cfg, device=dev)
        program = compiler.compile_model(params, cfg)
        if timed is None:
            timed = program
        recs = iegm.synth_diagnosis_batch(gen, PATIENTS, device=dev)["signal"]
        signals = iegm.synth_batch(gen, BUCKET, device=dev)["signal"]
        service = VAService(program, cfg, path="kernel", device=dev)
        runner = FleetRunner(program, cfg, path="kernel", device=dev)

        K.launches = 0
        diag_k = service.diagnose_batch(recs)
        torch.cuda.synchronize()
        n_service = K.launches
        preds_k = runner.classify(signals)
        torch.cuda.synchronize()
        n_runner = K.launches - n_service
        if main_launches is None:
            main_launches = K.launches
        n_sparse = len(layer_problems(cfg, vadetect))
        check(n_service == n_sparse and n_runner == n_sparse,
              f"{cname}: launches per execute {n_service}, {n_runner}, "
              f"expected {n_sparse}")

        # comparisons (their launches are not counted above)
        logits = {
            path: FleetRunner(program, cfg, path=path, device=dev).logits(signals)
            for path in ("kernel", "reference", "twin")
        }
        for path, y in logits.items():
            check(tuple(y.shape) == (BUCKET, 2), f"{cname} {path}: shape")
            check(bool(torch.isfinite(y).all()), f"{cname} {path}: non-finite")
        err_ref = float((logits["kernel"] - logits["reference"]).abs().max())
        err_twin = float((logits["twin"] - logits["reference"]).abs().max())
        am = {p: logits[p].argmax(-1) for p in logits}
        diag = {
            path: VAService(program, cfg, path=path, device=dev).diagnose_batch(recs)
            for path in ("reference", "twin")
        }
        cpu = program.to(torch.device("cpu"))
        y_cpu = compiler.execute(cpu, signals[:8].cpu(), cfg, path="reference")
        err_cpu = float((logits["kernel"][:8].cpu() - y_cpu).abs().max())
        emit({"phase": "service", "config": cname, "bucket": BUCKET,
              "patients": PATIENTS, "launches_service": n_service,
              "launches_runner": n_runner,
              "max_abs_err_kernel_vs_reference": err_ref,
              "max_abs_err_twin_vs_reference": err_twin,
              "max_abs_err_kernel_vs_cpu_reference": err_cpu,
              "va_segments_kernel": int(preds_k.sum()),
              "diagnoses_kernel": [d.is_va for d in diag_k]})
        check(err_ref <= LOGITS_TOL, f"{cname}: kernel vs reference {err_ref}")
        check(err_cpu <= LOGITS_TOL, f"{cname}: card vs CPU {err_cpu}")
        check(bool((am["kernel"] == am["reference"]).all()),
              f"{cname}: kernel and reference predictions differ")
        check(bool((am["kernel"] == am["twin"]).all()),
              f"{cname}: kernel and twin predictions differ")
        check(bool((preds_k == am["reference"]).all()),
              f"{cname}: classify differs from the reference argmax")
        for path, ds in diag.items():
            check([(d.is_va, d.segment_preds) for d in ds]
                  == [(d.is_va, d.segment_preds) for d in diag_k],
                  f"{cname}: {path} diagnoses differ from the kernel path's")
    check(main_launches and main_launches > 0, "main path launched no nm_spmm")

    # -- 4. times -------------------------------------------------------------
    program = timed
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    bytes_ms = ops_ms = 0.0
    for p, name in zip(problems, [m["name"] for m in program.layer_meta]):
        layer = program.layers[name]
        x = torch.randn((p["m"], p["k"]), generator=gen_dev, device=dev)
        args = (x, layer.values_q, layer.select, layer.scale)
        w_dense = decompress_tile(layer.values_q, layer.select, 16, 8) * layer.scale
        t = {
            "ms": device_ms(torch, lambda: K.nm_spmm_cuda(*args, group_size=16, keep=8)),
            "plain_ms": device_ms(torch, lambda: K.nm_spmm_plain(*args, group_size=16, keep=8)),
            "library_ms": device_ms(torch, lambda: torch.matmul(x, w_dense)),
        }
        b_ms, o_ms = bound(p["m"], p["k"], p["kk"], p["n"])
        t["bound_ms"] = max(b_ms, o_ms)
        bytes_ms, ops_ms = bytes_ms + b_ms, ops_ms + o_ms
        for key in totals:
            totals[key] += t[key]
        emit({"phase": "time", "kernel": K.NAME, **p, **t,
              "bound_by": "bytes" if b_ms >= o_ms else "operations"})
    signals = iegm.synth_batch(gen, BUCKET, device=dev)["signal"]
    for path in ("kernel", "reference", "twin"):
        runner = FleetRunner(program, va_cnn.CONFIG, path=path, device=dev)
        emit({"phase": "time", "execute": path, "bucket": BUCKET,
              "device_ms": device_ms(torch, lambda: runner.logits(signals)),
              "wall_ms": wall_ms(torch, lambda: runner.logits(signals))})

    check(not any(m == "jax" or m.startswith(("jax.", "repro."))
                  or m == "repro" for m in sys.modules),
          "jax or the JAX package was imported")
    emit({"kernels": [{
        "name": K.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/nm_spmm.cu",
        "replaces": "src/repro/kernels/nm_spmm.py:68",
        "launches": main_launches, "max_abs_err": max_abs_err,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": totals["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's VA diagnosis path and its kernel benchmark on
one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an H100 and the CUDA
toolkit. Phases, each printing JSON lines:

1. device — the card (nvidia-smi's name and power limit), then a build of
   every CUDA kernel (nm_spmm, sparse_conv1d, quant_matmul) from
   src/repro_torch/kernels/csrc, one nvcc each, all at once;
2. kernel — each kernel against its plain PyTorch version: nm_spmm and
   sparse_conv1d at the seven sparse VA layers at bucket 256 (the fused
   layer also against im2col -> pad -> nm_spmm, which execute runs), a
   head-like and a ragged shape; quant_matmul at 8/4/2/1 bits x three
   shapes;
3. service and benchmark — VAService.diagnose_batch and
   FleetRunner.classify on path="kernel" at full width (configs/va_cnn
   CONFIG, then MIXED), held against the reference and twin paths; then
   the kernel benchmark, repro_torch.benchmarks.kernels.run, on the card.
   Each run's kernel launches are counted from 0;
4. time — the floor of the timing method (a one-element add), then
   kernel, plain version, one library call and the bound at each VA layer
   and benchmark shape, the fused layer against im2col + nm_spmm, and the
   whole execute, on the card.

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
CONV_EXTRA = (  # (B, T, C, N, ksize, stride) beside the VA layers
    (2, 16, 96, 2, 1, 1),  # head-like: 1x1, N = 2
    (3, 200, 8, 40, 5, 2),  # ragged: T_out 100 and N 40 off the tiles
)
QUANT_SHAPES = ((128, 512, 256), (33, 128, 40), (8, 64, 16))  # (M, K, N)
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


def conv_bound(x, n: int, kk: int, valid: int, t_out: int) -> tuple[float, float]:
    """Least times in ms for one sparse_conv1d: (bytes, operations) — x,
    values, select and scale read once and y written once at the HBM rate,
    and 2 * B * T_out * (compressed weights inside the window) float32
    operations at the float32 rate. Weights in the group padding are
    skipped by the kernel and not counted."""
    b = x.shape[0]
    nbytes = x.numel() * 4 + kk * n * 2 + n * 4 + b * t_out * n * 4
    ops = 2 * b * t_out * valid
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3


def quant_bound(m: int, k: int, n: int, packed_bytes: int) -> tuple[float, float]:
    """Least times in ms for one quant_matmul: (bytes, operations) — x,
    the packed weight and scale read once and y written once, and
    2 * M * K * N float32 operations."""
    nbytes = m * k * 4 + packed_bytes + n * 4 + m * n * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, 2 * m * k * n / F32_FLOP_PER_S * 1e3


def rel_err(y, y_ref) -> tuple[float, float]:
    """(max abs error, that over max|y_ref|)."""
    err = float((y - y_ref).abs().max())
    return err, err / max(float(y_ref.abs().max()), 1e-30)


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

    import torch.nn.functional as F

    from repro_torch.benchmarks import kernels as bench
    from repro_torch.configs import va_cnn
    from repro_torch.core import compiler, quant, spe, vadetect
    from repro_torch.data import iegm
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels import sparse_conv1d as SC
    from repro_torch.kernels._common import decompress_tile, unpack_tile
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
    built = _build.build((K.NAME, SC.NAME, QM.NAME))
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

    # sparse_conv1d: the seven sparse VA layers of the CONFIG program
    # (phase 3's first program: same seed) at bucket 256, then the extras
    cfg = va_cnn.CONFIG
    conv_program = compiler.compile_model(
        vadetect.init(torch.Generator().manual_seed(SEED), cfg, device=dev), cfg
    )
    conv_cases = []
    for m in conv_program.layer_meta:
        layer = conv_program.layers[m["name"]]
        if layer.sparse:
            conv_cases.append((m["name"], (BUCKET, m["t_in"], m["c_in"]),
                               m["ksize"], m["stride"], layer, True))
    for b, t_in, c, n, ks, stride in CONV_EXTRA:
        w = torch.randn((-(-(ks * c) // 16) * 16, n), generator=gen_dev, device=dev)
        conv_cases.append((f"extra_{b}x{t_in}x{c}_n{n}", (b, t_in, c), ks,
                           stride, spe.compile_layer(w, spe.SPEConfig()), False))
    conv_err = 0.0
    for name, shape, ks, stride, layer, va_layer in conv_cases:
        x = torch.randn(shape, generator=gen_dev, device=dev)
        args = (x, layer.values_q, layer.select, layer.scale)
        kw = dict(ksize=ks, stride=stride, group_size=16, keep=8)
        y_k = SC.sparse_conv1d_cuda(*args, **kw)
        torch.cuda.synchronize()
        y_p = SC.sparse_conv1d_plain(*args, **kw)
        torch.cuda.synchronize()
        err, rel = rel_err(y_k, y_p)
        conv_err = max(conv_err, err)
        line = {"phase": "kernel", "kernel": SC.NAME, "layer": name,
                "x": list(shape), "n": layer.values_q.shape[1], "ksize": ks,
                "stride": stride, "max_abs_err": err, "rel_err": rel,
                "tol": KERNEL_RTOL}
        t_out = (shape[1] - 1) // stride + 1
        check(tuple(y_k.shape) == (shape[0], t_out, layer.values_q.shape[1]),
              f"{name}: shape {tuple(y_k.shape)}")
        check(bool(torch.isfinite(y_k).all()), f"{name}: non-finite output")
        check(rel <= KERNEL_RTOL, f"{name}: sparse_conv1d vs plain rel err {rel}")
        if va_layer:
            # execute's own computation of the layer, before bias
            flat = spe.im2col(x, ks, stride)
            flat = F.pad(flat, (0, layer.k_dense - flat.shape[-1]))
            y_mm = ops.nm_spmm(flat, layer.values_q, layer.select, layer.scale,
                               group_size=16, keep=8)
            torch.cuda.synchronize()
            err_mm, rel_mm = rel_err(y_k, y_mm)
            line.update(max_abs_err_vs_im2col_nm_spmm=err_mm,
                        rel_err_vs_im2col_nm_spmm=rel_mm)
            check(rel_mm <= KERNEL_RTOL,
                  f"{name}: sparse_conv1d vs im2col + nm_spmm rel err {rel_mm}")
        emit(line)

    # quant_matmul: every bit width at the benchmark's and the tests' shapes
    quant_err = 0.0
    for bits in QM.BITS:
        for m_q, k_q, n_q in QUANT_SHAPES:
            w = torch.randn((k_q, n_q), generator=gen_dev, device=dev)
            q, sc = quant.quantize(w, quant.QuantConfig(bits=bits))
            packed = quant.pack_planes(q, bits)
            x = torch.randn((m_q, k_q), generator=gen_dev, device=dev)
            y_k = QM.quant_matmul_cuda(x, packed, sc, bits=bits)
            torch.cuda.synchronize()
            y_p = QM.quant_matmul_plain(x, packed, sc, bits=bits)
            torch.cuda.synchronize()
            err, rel = rel_err(y_k, y_p)
            quant_err = max(quant_err, err)
            emit({"phase": "kernel", "kernel": QM.NAME, "bits": bits,
                  "m": m_q, "k": k_q, "n": n_q, "max_abs_err": err,
                  "rel_err": rel, "tol": KERNEL_RTOL})
            check(tuple(y_k.shape) == (m_q, n_q), f"quant {bits}b: shape")
            check(bool(torch.isfinite(y_k).all()), f"quant {bits}b: non-finite")
            check(rel <= KERNEL_RTOL,
                  f"quant_matmul {bits}b {(m_q, k_q, n_q)}: rel err {rel}")

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

        K.launches = SC.launches = QM.launches = 0
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
        check(SC.launches == 0 and QM.launches == 0,
              f"{cname}: execute launched sparse_conv1d {SC.launches}, "
              f"quant_matmul {QM.launches} times; it runs only nm_spmm")

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

    # the kernel benchmark on the card: per row one warm call + REPS
    calls = 1 + bench.REPS
    expected = {K.NAME: calls, SC.NAME: calls, QM.NAME: 4 * calls}
    K.launches = SC.launches = QM.launches = 0
    rows = bench.run(device="cuda")
    torch.cuda.synchronize()
    bench_launches = {K.NAME: K.launches, SC.NAME: SC.launches,
                      QM.NAME: QM.launches}
    emit({"phase": "benchmark", "entry": "repro_torch.benchmarks.kernels.run",
          "rows": [{"name": r[0], "us_per_call": r[1], "derived": r[2]}
                   for r in rows],
          "launches": bench_launches, "expected_launches": expected})
    check(bench_launches == expected,
          f"benchmark launches {bench_launches}, expected {expected}")

    # -- 4. times -------------------------------------------------------------
    # the floor of device_ms: one launch that does next to no work
    one = torch.zeros(1, device=dev)
    emit({"phase": "time", "floor": "one-element add_",
          "ms": device_ms(torch, lambda: one.add_(1.0))})
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
    conv_totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                       im2col_nm_spmm_ms=0.0)
    conv_bytes_ms = conv_ops_ms = 0.0
    for m in program.layer_meta:
        layer = program.layers[m["name"]]
        if not layer.sparse:
            continue
        ks, stride, c, n = m["ksize"], m["stride"], m["c_in"], m["c_out"]
        x = torch.randn((BUCKET, m["t_in"], c), generator=gen_dev, device=dev)
        args = (x, layer.values_q, layer.select, layer.scale)
        kw = dict(ksize=ks, stride=stride, group_size=16, keep=8)
        w_dense = decompress_tile(layer.values_q, layer.select, 16, 8) * layer.scale
        w_conv = w_dense[: ks * c].reshape(ks, c, n)

        def im2col_nm_spmm(x=x, layer=layer, ks=ks, stride=stride):
            flat = spe.im2col(x, ks, stride)
            flat = F.pad(flat, (0, layer.k_dense - flat.shape[-1]))
            return ops.nm_spmm(flat, layer.values_q, layer.select, layer.scale,
                               group_size=16, keep=8)

        t = {
            "ms": device_ms(torch, lambda: SC.sparse_conv1d_cuda(*args, **kw)),
            "plain_ms": device_ms(torch, lambda: SC.sparse_conv1d_plain(*args, **kw)),
            "library_ms": device_ms(torch, lambda: spe.conv1d_same(x, w_conv, stride)),
            "im2col_nm_spmm_ms": device_ms(torch, im2col_nm_spmm),
        }
        kk = layer.values_q.shape[0]
        rows_d = (torch.arange(kk, device=dev) // 8)[:, None] * 16 + layer.select.long()
        valid = int((rows_d < ks * c).sum())
        b_ms, o_ms = conv_bound(x, n, kk, valid, m["t_out"])
        t["bound_ms"] = max(b_ms, o_ms)
        conv_bytes_ms, conv_ops_ms = conv_bytes_ms + b_ms, conv_ops_ms + o_ms
        for key in conv_totals:
            conv_totals[key] += t[key]
        emit({"phase": "time", "kernel": SC.NAME, "layer": m["name"],
              "x": list(x.shape), "n": n, "ksize": ks, "stride": stride,
              "kk": kk, "valid_weights": valid, **t,
              "bound_by": "bytes" if b_ms >= o_ms else "operations"})

    quant_totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    quant_bytes_ms = quant_ops_ms = 0.0
    for bits in QM.BITS:
        w = torch.randn((bench.K, bench.N), generator=gen_dev, device=dev)
        q, sc = quant.quantize(w, quant.QuantConfig(bits=bits))
        packed = quant.pack_planes(q, bits)
        x = torch.randn((bench.M, bench.K), generator=gen_dev, device=dev)
        w_deq = unpack_tile(packed, bits).to(torch.float32) * sc
        t = {
            "ms": device_ms(torch, lambda: QM.quant_matmul_cuda(x, packed, sc, bits=bits)),
            "plain_ms": device_ms(torch, lambda: QM.quant_matmul_plain(x, packed, sc, bits=bits)),
            "library_ms": device_ms(torch, lambda: torch.matmul(x, w_deq)),
        }
        b_ms, o_ms = quant_bound(bench.M, bench.K, bench.N, packed.numel())
        t["bound_ms"] = max(b_ms, o_ms)
        quant_bytes_ms, quant_ops_ms = quant_bytes_ms + b_ms, quant_ops_ms + o_ms
        for key in quant_totals:
            quant_totals[key] += t[key]
        emit({"phase": "time", "kernel": QM.NAME, "bits": bits, "m": bench.M,
              "k": bench.K, "n": bench.N, **t,
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
        "at": "sum of the 7 sparse VA layers at bucket 256; launches over "
              "the service run",
    }, {
        "name": SC.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sparse_conv1d.cu",
        "replaces": "src/repro/kernels/sparse_conv1d.py:64",
        "launches": bench_launches[SC.NAME], "max_abs_err": conv_err,
        "ms": conv_totals["ms"], "plain_ms": conv_totals["plain_ms"],
        "bound_ms": conv_totals["bound_ms"],
        "bound_by": "bytes" if conv_bytes_ms >= conv_ops_ms else "operations",
        "library_ms": conv_totals["library_ms"],
        "im2col_nm_spmm_ms": conv_totals["im2col_nm_spmm_ms"],
        "at": "sum of the 7 sparse VA layers at bucket 256; launches over "
              "the benchmark run",
    }, {
        "name": QM.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:42",
        "launches": bench_launches[QM.NAME], "max_abs_err": quant_err,
        "ms": quant_totals["ms"], "plain_ms": quant_totals["plain_ms"],
        "bound_ms": quant_totals["bound_ms"],
        "bound_by": "bytes" if quant_bytes_ms >= quant_ops_ms else "operations",
        "library_ms": quant_totals["library_ms"],
        "at": "sum of 8/4/2/1 bits at the benchmark shape (128, 512, 256); "
              "launches over the benchmark run",
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

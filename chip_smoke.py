#!/usr/bin/env python3
"""Drive the PyTorch port's VA diagnosis path, its kernel benchmark, the
CMUL sweep, VA co-design training (the quickstart) and the streaming fleet
on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an H100 and the CUDA
toolkit. Phases, each printing JSON lines:

1. device — the card (nvidia-smi's name and power limit), then a build of
   every CUDA kernel (nm_spmm, sparse_conv1d, quant_matmul,
   bitserial_matmul) from src/repro_torch/kernels/csrc, one nvcc each,
   all at once, with ptxas's registers and spills; the tensor-core
   instructions (HGMMA) in the SASS of all four;
2. kernel — each kernel against its plain PyTorch version: nm_spmm and
   sparse_conv1d at the seven sparse VA layers at bucket 256 (the fused
   layer also against im2col -> pad -> nm_spmm, which execute runs, bit
   for bit), a head-like and a ragged shape, each twice, bit-identical,
   and their geometry (tile width, grid) at each layer; quant_matmul at 8/4/2/1 bits x three
   shapes and at (64, 4096, 4096) at 8 and 1 bits; bitserial_matmul at the
   same 14 cases, also against the CUDA quant_matmul and
   quant.quantized_matmul(exact_bitserial=True); both twice on the same
   inputs, bit-identical; their grid and cluster at the benchmark shape;
3. paths — VAService.diagnose_batch and FleetRunner.classify on
   path="kernel" at full width (configs/va_cnn CONFIG, then MIXED), held
   against the reference and twin paths; the kernel benchmark,
   repro_torch.benchmarks.kernels.run; the CMUL sweep through
   ops.bitserial_matmul; the cuDNN TF32 check of the training path's
   convolutions; the quickstart, repro_torch.examples.quickstart.run, at
   full width (200 adam steps at batch 64, compile, diagnose on the
   kernel path); and one train step on the card against the same step on
   the CPU for CONFIG, MIXED and DENSE. Each path's kernel launches are
   counted from 0;
   fleet — nm_spmm against its plain version at the seven layers of the
   fleet's program for every bucket a fleet run declares (8, 32, 128,
   512), with its geometry there; the 1000-patient streaming fleet
   (repro_torch.stream.simulate with repro_torch.examples.stream_fleet's
   set-up: sources -> scheduler -> runner -> vote) on path="kernel" and
   path="twin", its nm_spmm launches counted from 0 (7 a bucket, the
   warm-up buckets included, on the kernel path; none on the twin path),
   no drops and a real-time factor of at least 1 on both, the same
   counts; every kernel-path bucket's logits, recorded in that run, held
   against the twin path's on the same input; then FLEET_REPS more runs a
   path in turns, the last with telemetry on for the pack / classify /
   vote split from its spans, the others for the spread of the
   wall; and the throughput benchmark,
   repro_torch.benchmarks.stream_throughput.run(smoke=True), with its
   checks;
4. time — the floor of the timing method (a one-element add), then
   kernel, plain version, one library call and the bound at each VA layer
   and benchmark shape, the fused layer against im2col + nm_spmm, the
   whole execute (CONFIG and MIXED, kernel and dense "twin" paths, CONFIG
   also the reference path; the fleet's program at its buckets 32, 128 and
   512 on both fleet paths), and one train step (host and device time),
   on the card. Every kernel and its library call are also timed per
   launch in a run of RUN_LAUNCHES (ms_in_run), against both bounds,
   float32 and tensor-core (tc_bound_ms); the CMUL pair also at
   (64, 4096, 4096) at 8 and 1 bits.

The line before the last is the {"kernels": [...]} summary, the last
{"ok": true, "device": {...}}. Any failure exits non-zero before either;
so does a host without a CUDA card, or a directory without the port.
Imports nothing of jax and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
# a qwen3-8b projection's width (src/repro/configs/qwen3_8b.py) at 64 rows,
# at these widths
LARGE, LARGE_BITS = (64, 4096, 4096), (8, 1)
CMUL_SWEEP = ((8, 64, 16), (33, 128, 40))  # tests/test_kernels.py's sweep
KERNEL_RTOL = 1e-4  # max|kernel - plain| / max|plain| (f32, tests/test_kernels.py)
DEQUANT_TOL = 1e-3  # against x @ dequantize(q, scale) (tests/test_kernels.py)
LOGITS_TOL = 1e-3  # kernel path vs reference path (tests/test_vadetect.py)
# one train step, card against CPU: max|card - cpu| / max|cpu| of the loss,
# grad norm, params and moments. Both are float32; cuDNN sums the
# convolutions' gradients in another (and run-to-run varying) order than
# the CPU, and Adam's warm moments pass that on at its own size.
STEP_RTOL = 1e-4
TF32_RTOL = 1e-5  # a float32 gradient held against one with TF32 allowed
TRAIN_BATCH = 64  # the quickstart's batch
REPS = 15  # timed runs per function; the median is kept
RUN_LAUNCHES = 100  # back-to-back launches a ms_in_run run
RUN_REPS = 5  # ms_in_run runs; the median is kept
RUN_SLEEP_CYCLES = 40_000_000  # covers the host's enqueue of one run or bucket
STEP_SLEEP_CYCLES = 100_000_000  # covers the host's enqueue of one train step
PROFILE_STEPS = 5
# every bucket a fleet run declares: the example's (32, 128, 512) and the
# throughput benchmark's smaller drain bucket (8)
FLEET_KERNEL_BUCKETS = (8, 32, 128, 512)
FLEET_REPS = 4  # fleet runs a path after the counted one: spread, then spans
# the counts of a fleet run, equal on the kernel and the twin path
FLEET_COUNTS = ("segments_total", "batches_total", "padded_total",
                "diagnoses_total", "va_diagnoses_total", "urgent_packed_total",
                "dropped_total", "batches_by_bucket")
# H100 SXM data sheet: HBM rate, float32 outside the tensor cores, and TF32
# on them (dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def device_ms(torch, fn, sleep_cycles: int = 2_000_000, enqueue=None) -> float:
    """Median device time of `fn` in ms over REPS runs, warm. A sleep
    kernel ahead of each run keeps the card busy while the host enqueues
    the run, so host overhead does not count as long as the enqueue ends
    before the sleep does (`fn` must not wait on the card). Where
    `enqueue` is a list, the host's enqueue times in ms are appended."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        t0 = time.perf_counter()
        fn()
        if enqueue is not None:
            enqueue.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_ms(torch, fn) -> tuple[float, float]:
    """Device time per launch in ms over RUN_LAUNCHES back-to-back calls of
    `fn` between two CUDA events, median of RUN_REPS runs, warm, and the
    longest host enqueue of a run in ms. A sleep kernel ahead of each run
    keeps the card busy while the host enqueues it, so the launches run
    back to back on the card (the enqueue must end before the sleep: the
    caller compares it with the sleep's time)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, enqueue = [], 0.0
    for _ in range(RUN_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(RUN_SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(RUN_LAUNCHES):
            fn()
        enqueue = max(enqueue, (time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / RUN_LAUNCHES)
    return statistics.median(times), enqueue


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


def spe_tc_bound_ms(nbytes_ms: float, m: int, k: int, n: int) -> float:
    """Least time in ms for one nm_spmm or sparse_conv1d on the tensor
    cores: its bytes (`nbytes_ms`, from `bound` or `conv_bound`) against the
    two TF32 passes over the dense K x N, 2 * (2 * M * K * N) operations at
    the TF32 rate; the larger."""
    return max(nbytes_ms, 2 * 2 * m * k * n / TF32_FLOP_PER_S * 1e3)


def quant_bound(m: int, k: int, n: int, packed_bytes: int) -> tuple[float, float]:
    """Least times in ms for one quant_matmul or bitserial_matmul (the same
    function): (bytes, operations) — x, the packed weight and scale read
    once and y written once, and 2 * M * K * N float32 operations."""
    nbytes = m * k * 4 + packed_bytes + n * 4 + m * n * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, 2 * m * k * n / F32_FLOP_PER_S * 1e3


def tc_bound_ms(m: int, k: int, n: int, packed_bytes: int) -> float:
    """Least time in ms for one quant_matmul or bitserial_matmul on the
    tensor cores: the bytes of `quant_bound` against the two TF32 passes,
    2 * (2 * M * K * N) operations at the TF32 rate; the larger."""
    nbytes_ms, _ = quant_bound(m, k, n, packed_bytes)
    return max(nbytes_ms, 2 * 2 * m * k * n / TF32_FLOP_PER_S * 1e3)


def sass_count(cuobjdump: Path, path: Path, op: str) -> int:
    """How often the SASS of the library at `path` names the instruction
    `op` (`cuobjdump -sass`)."""
    out = subprocess.run([str(cuobjdump), "-sass", str(path)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    return out.count(op)


def rel_err(y, y_ref) -> tuple[float, float]:
    """(max abs error, that over max|y_ref|)."""
    err = float((y - y_ref).abs().max())
    return err, err / max(float(y_ref.abs().max()), 1e-30)


def tree_rel(got: dict, want: dict, leaves) -> float:
    """max |got - want| / max |want| over two trees of one structure."""
    pairs = list(zip(leaves(got), leaves(want)))
    err = max(float((g.cpu() - w.cpu()).abs().max()) for g, w in pairs)
    return err / max(max(float(w.abs().max()) for _, w in pairs), 1e-30)


def layer_problems(cfg, vadetect, bucket: int = BUCKET) -> list[dict]:
    """(M, K, Kk, N) of every sparse layer's nm_spmm at `bucket`."""
    out = []
    for i, m in enumerate(vadetect.layer_shapes(cfg)):
        spe = cfg.layer_spe(i)
        if not (spe and spe.sparse):
            continue
        k = -(-(m["ksize"] * m["c_in"]) // spe.group_size) * spe.group_size
        out.append(dict(layer=m["name"], m=bucket * m["t_out"], k=k,
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

    from repro_torch import obs, optim
    from repro_torch._tree import leaves, tree_map
    from repro_torch.benchmarks import kernels as bench
    from repro_torch.benchmarks import stream_throughput
    from repro_torch.configs import va_cnn
    from repro_torch.core import compiler, quant, spe, vadetect
    from repro_torch.data import iegm
    from repro_torch.examples import quickstart, stream_fleet
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import bitserial as BS
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels import sparse_conv1d as SC
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels._common import decompress_tile, unpack_tile
    from repro_torch.serve.va_service import VAService
    from repro_torch.stream import FleetRunner, simulate
    from repro_torch.train import trainer

    # full float32 for every reference matmul (the default; stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_main = time.perf_counter()

    def clock(after: str) -> None:
        """Seconds since the imports, at the end of each phase."""
        emit({"phase": "clock", "after": after,
              "seconds": time.perf_counter() - t_main})

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
    built = _build.build((K.NAME, SC.NAME, QM.NAME, BS.NAME))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": [{"name": b.name, "seconds": b.seconds,
                       "ptxas": [ln.strip() for ln in b.log.splitlines()
                                 if ("ptxas info" in ln and "Used" in ln)
                                 or "spill" in ln]}
                      for b in built]})
    # the tensor cores in all four kernels: wgmma compiles to HGMMA
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    with ThreadPoolExecutor(len(built)) as pool:  # one cuobjdump each, at once
        counts = list(pool.map(
            lambda b: sass_count(cuobjdump, b.path, "HGMMA"), built))
    hgmma = {b.name: n for b, n in zip(built, counts)}
    emit({"phase": "sass", "hgmma": hgmma})
    check(len(hgmma) == 4 and min(hgmma.values()) > 0,
          f"no HGMMA in the SASS of some kernel: {hgmma}")

    clock("device and build")

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
        y_again = K.nm_spmm_cuda(*args, group_size=16, keep=8)
        torch.cuda.synchronize()
        y_p = K.nm_spmm_plain(*args, group_size=16, keep=8)
        torch.cuda.synchronize()
        err = float((y_k - y_p).abs().max())
        rel = err / max(float(y_p.abs().max()), 1e-30)
        max_abs_err = max(max_abs_err, err)
        same = torch.equal(y_k, y_again)
        emit({"phase": "kernel", "kernel": K.NAME, **p, "max_abs_err": err,
              "rel_err": rel, "tol": KERNEL_RTOL, "repeat_identical": same})
        check(tuple(y_k.shape) == (p["m"], p["n"]), f"{p}: shape {tuple(y_k.shape)}")
        check(bool(torch.isfinite(y_k).all()), f"{p}: non-finite output")
        check(rel <= KERNEL_RTOL, f"{p}: kernel vs plain rel err {rel}")
        check(same, f"{p}: nm_spmm repeat differs")

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
        y_again = SC.sparse_conv1d_cuda(*args, **kw)
        torch.cuda.synchronize()
        y_p = SC.sparse_conv1d_plain(*args, **kw)
        torch.cuda.synchronize()
        err, rel = rel_err(y_k, y_p)
        conv_err = max(conv_err, err)
        same = torch.equal(y_k, y_again)
        line = {"phase": "kernel", "kernel": SC.NAME, "layer": name,
                "x": list(shape), "n": layer.values_q.shape[1], "ksize": ks,
                "stride": stride, "max_abs_err": err, "rel_err": rel,
                "tol": KERNEL_RTOL, "repeat_identical": same}
        check(same, f"{name}: sparse_conv1d repeat differs")
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
            exact = torch.equal(y_k.reshape(y_mm.shape), y_mm)
            line.update(max_abs_err_vs_im2col_nm_spmm=err_mm,
                        rel_err_vs_im2col_nm_spmm=rel_mm,
                        identical_to_im2col_nm_spmm=exact)
            check(exact, f"{name}: sparse_conv1d differs from im2col + "
                  f"nm_spmm (rel err {rel_mm})")
        emit(line)

    # quant_matmul: every bit width at the benchmark's and the tests' shapes,
    # and the large shape at two widths; each twice, bit-identical
    cmul_cases = [(bits, shape) for bits in QM.BITS for shape in QUANT_SHAPES]
    cmul_cases += [(bits, LARGE) for bits in LARGE_BITS]
    # the large shape draws from its own generator, so that every later
    # input drawn from gen_dev is what it was before these cases existed
    gen_large = torch.Generator(device=dev).manual_seed(SEED + 1)
    quant_err = 0.0
    for bits, (m_q, k_q, n_q) in cmul_cases:
        g = gen_large if (m_q, k_q, n_q) == LARGE else gen_dev
        w = torch.randn((k_q, n_q), generator=g, device=dev)
        q, sc = quant.quantize(w, quant.QuantConfig(bits=bits))
        packed = quant.pack_planes(q, bits)
        x = torch.randn((m_q, k_q), generator=g, device=dev)
        y_k = QM.quant_matmul_cuda(x, packed, sc, bits=bits)
        y_again = QM.quant_matmul_cuda(x, packed, sc, bits=bits)
        torch.cuda.synchronize()
        y_p = QM.quant_matmul_plain(x, packed, sc, bits=bits)
        torch.cuda.synchronize()
        err, rel = rel_err(y_k, y_p)
        quant_err = max(quant_err, err)
        same = torch.equal(y_k, y_again)
        emit({"phase": "kernel", "kernel": QM.NAME, "bits": bits,
              "m": m_q, "k": k_q, "n": n_q, "max_abs_err": err,
              "rel_err": rel, "tol": KERNEL_RTOL, "repeat_identical": same})
        check(tuple(y_k.shape) == (m_q, n_q), f"quant {bits}b: shape")
        check(bool(torch.isfinite(y_k).all()), f"quant {bits}b: non-finite")
        check(rel <= KERNEL_RTOL,
              f"quant_matmul {bits}b {(m_q, k_q, n_q)}: rel err {rel}")
        check(same, f"quant_matmul {bits}b {(m_q, k_q, n_q)}: repeat differs")

    # bitserial_matmul: the same 14 cases, against its plain version, the
    # CUDA quant_matmul on the same packed weight, and the core CMUL math
    bs_err = 0.0
    for bits, (m_q, k_q, n_q) in cmul_cases:
        g = gen_large if (m_q, k_q, n_q) == LARGE else gen_dev
        w = torch.randn((k_q, n_q), generator=g, device=dev)
        q, sc = quant.quantize(w, quant.QuantConfig(bits=bits))
        packed = quant.pack_planes(q, bits)
        x = torch.randn((m_q, k_q), generator=g, device=dev)
        y_k = BS.bitserial_matmul_cuda(x, packed, sc, bits=bits)
        y_again = BS.bitserial_matmul_cuda(x, packed, sc, bits=bits)
        torch.cuda.synchronize()
        others = {
            "plain": BS.bitserial_matmul_plain(x, packed, sc, bits=bits),
            "quant_matmul": QM.quant_matmul_cuda(x, packed, sc, bits=bits),
            "quantized_matmul_exact_bitserial": quant.quantized_matmul(
                x, q, sc, bits, exact_bitserial=True),
        }
        torch.cuda.synchronize()
        same = torch.equal(y_k, y_again)
        line = {"phase": "kernel", "kernel": BS.NAME, "bits": bits,
                "m": m_q, "k": k_q, "n": n_q, "tol": KERNEL_RTOL,
                "repeat_identical": same}
        check(tuple(y_k.shape) == (m_q, n_q), f"bitserial {bits}b: shape")
        check(bool(torch.isfinite(y_k).all()), f"bitserial {bits}b: non-finite")
        for name, y_o in others.items():
            err, rel = rel_err(y_k, y_o)
            if name == "plain":
                bs_err = max(bs_err, err)
            line[f"max_abs_err_vs_{name}"] = err
            line[f"rel_err_vs_{name}"] = rel
            check(rel <= KERNEL_RTOL, f"bitserial_matmul {bits}b "
                  f"{(m_q, k_q, n_q)} vs {name}: rel err {rel}")
        emit(line)
        check(same, f"bitserial_matmul {bits}b {(m_q, k_q, n_q)}: repeat differs")

    # the SPE kernels' launch geometry at each VA layer (the fused layer's
    # B * T_out output steps are nm_spmm's M)
    for p in problems:
        emit({"phase": "geometry", "kernel": K.NAME, **p,
              **K.launch_geometry(p["m"], p["k"], p["n"])})
        emit({"phase": "geometry", "kernel": SC.NAME, **p,
              **SC.launch_geometry(BUCKET, p["m"] // BUCKET, p["k"], p["n"])})

    # the launch geometry of both at the benchmark shape, per width, and at
    # the large shape
    for mod in (QM, BS):
        for bits, (m_q, k_q, n_q) in (
                [(b, (bench.M, bench.K, bench.N)) for b in mod.BITS]
                + [(b, LARGE) for b in LARGE_BITS]):
            emit({"phase": "geometry", "kernel": mod.NAME, "bits": bits,
                  "m": m_q, "k": k_q, "n": n_q,
                  **mod.launch_geometry(m_q, k_q, n_q, bits=bits)})

    clock("kernel")

    # -- 3. the service path at full width ----------------------------------
    main_launches = None
    gen = torch.Generator().manual_seed(SEED)  # CPU: same weights anywhere
    timed = {}  # each program, timed in phase 4
    for cname, cfg in (("CONFIG", va_cnn.CONFIG), ("MIXED", va_cnn.MIXED)):
        params = vadetect.init(gen, cfg, device=dev)
        program = compiler.compile_model(params, cfg)
        timed[cname] = (program, cfg)
        recs = iegm.synth_diagnosis_batch(gen, PATIENTS, device=dev)["signal"]
        signals = iegm.synth_batch(gen, BUCKET, device=dev)["signal"]
        service = VAService(program, cfg, path="kernel", device=dev)
        runner = FleetRunner(program, cfg, path="kernel", device=dev)

        K.launches = SC.launches = QM.launches = BS.launches = 0
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
        check(SC.launches == 0 and QM.launches == 0 and BS.launches == 0,
              f"{cname}: execute launched sparse_conv1d {SC.launches}, "
              f"quant_matmul {QM.launches}, bitserial_matmul {BS.launches} "
              "times; it runs only nm_spmm")

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
    expected = {K.NAME: calls, SC.NAME: calls, QM.NAME: 4 * calls, BS.NAME: 0}
    K.launches = SC.launches = QM.launches = BS.launches = 0
    rows = bench.run(device="cuda")
    torch.cuda.synchronize()
    bench_launches = {K.NAME: K.launches, SC.NAME: SC.launches,
                      QM.NAME: QM.launches, BS.NAME: BS.launches}
    emit({"phase": "benchmark", "entry": "repro_torch.benchmarks.kernels.run",
          "rows": [{"name": r[0], "us_per_call": r[1], "derived": r[2]}
                   for r in rows],
          "launches": bench_launches, "expected_launches": expected})
    check(bench_launches == expected,
          f"benchmark launches {bench_launches}, expected {expected}")

    # the CMUL sweep (tests/test_kernels.py:43-60, the only caller of the
    # reference's bitserial kernel): ops.bitserial_matmul and
    # ops.quant_matmul on every width at the sweep's two shapes
    sweep = []
    for bits in BS.BITS:
        for m_q, k_q, n_q in CMUL_SWEEP:
            w = torch.randn((k_q, n_q), generator=gen_dev, device=dev)
            q, sc = quant.quantize(w, quant.QuantConfig(bits=bits))
            x = torch.randn((m_q, k_q), generator=gen_dev, device=dev)
            sweep.append((bits, x, q, sc, quant.pack_planes(q, bits)))
    K.launches = SC.launches = QM.launches = BS.launches = 0
    outs = [(ops.bitserial_matmul(x, packed, sc, bits=bits),
             ops.quant_matmul(x, packed, sc, bits=bits))
            for bits, x, q, sc, packed in sweep]
    torch.cuda.synchronize()
    sweep_launches = {K.NAME: K.launches, SC.NAME: SC.launches,
                      QM.NAME: QM.launches, BS.NAME: BS.launches}
    expected = {K.NAME: 0, SC.NAME: 0, QM.NAME: len(sweep), BS.NAME: len(sweep)}
    worst = dict(ref=0.0, quant=0.0, dequant=0.0)
    for (bits, x, q, sc, packed), (y_b, y_q) in zip(sweep, outs):
        y_ref = kref.bitserial_matmul_ref(x, packed, sc, bits=bits,
                                          k=x.shape[1])
        y_deq = x @ quant.dequantize(q, sc)
        worst["ref"] = max(worst["ref"], rel_err(y_b, y_ref)[1])
        worst["quant"] = max(worst["quant"], rel_err(y_q, y_ref)[1])
        worst["dequant"] = max(worst["dequant"], rel_err(y_b, y_deq)[1])
    emit({"phase": "cmul_sweep", "entry": "kernels.ops.bitserial_matmul",
          "cases": len(sweep), "launches": sweep_launches,
          "expected_launches": expected,
          "rel_err_bitserial_vs_ref": worst["ref"],
          "rel_err_quant_matmul_vs_ref": worst["quant"],
          "rel_err_bitserial_vs_dequant_matmul": worst["dequant"]})
    check(sweep_launches == expected,
          f"CMUL sweep launches {sweep_launches}, expected {expected}")
    check(worst["ref"] <= KERNEL_RTOL and worst["quant"] <= KERNEL_RTOL,
          f"CMUL sweep against the oracle: {worst}")
    check(worst["dequant"] <= DEQUANT_TOL,
          f"CMUL sweep against x @ dequantize: {worst}")

    # cuDNN's TF32 in the backward of the training path's convolutions: per
    # VA layer at the quickstart's batch, gradients with TF32 allowed (the
    # library's default) against those of a float32 convolution, for the
    # former form (TF32 off around the forward only, so the backward ran
    # outside the flags) and for the port's spe.conv1d_same
    def conv_grads(x, w, stride, form):
        x = x.detach().requires_grad_(True)
        w = w.detach().requires_grad_(True)
        if form == "port":
            y = spe.conv1d_same(x, w, stride)
        else:
            _, pad_l, pad_r = spe.same_padding(x.shape[1], w.shape[0], stride)
            xc = F.pad(x.transpose(1, 2), (pad_l, pad_r))
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                y = F.conv1d(xc, w.permute(2, 1, 0), stride=stride)
            y = y.transpose(1, 2)
        g_y = torch.ones_like(y).bernoulli_(0.5, generator=gen_dev) - 0.5
        return torch.autograd.grad((y * g_y).sum(), (x, w))

    tf32_default = torch.backends.cudnn.allow_tf32
    tf32_rows = []
    for m in vadetect.layer_shapes(va_cnn.CONFIG):
        x = torch.randn((TRAIN_BATCH, m["t_in"], m["c_in"]), generator=gen_dev,
                        device=dev)
        w = torch.randn((m["ksize"], m["c_in"], m["c_out"]), generator=gen_dev,
                        device=dev) * (2.0 / (m["ksize"] * m["c_in"])) ** 0.5
        seed = int(torch.randint(2**31, (1,), generator=gen_dev, device=dev))
        grads = {}
        for form, tf32 in (("f32", False), ("former", True), ("port", True)):
            torch.backends.cudnn.allow_tf32 = tf32
            gen_dev.manual_seed(seed)  # the same upstream gradient for each
            grads[form] = conv_grads(x, w, m["stride"],
                                     "port" if form == "port" else "former")
        torch.backends.cudnn.allow_tf32 = tf32_default
        row = {"layer": m["name"]}
        for form in ("former", "port"):
            for name, g, g_ref in zip(("x", "w"), grads[form], grads["f32"]):
                row[f"rel_err_{form}_grad_{name}"] = rel_err(g, g_ref)[1]
        tf32_rows.append(row)
    # the whole loss's gradients, TF32 allowed against not
    cfg = va_cnn.CONFIG
    params = vadetect.init(torch.Generator().manual_seed(SEED), cfg, device=dev)
    batch = iegm.IEGMStream(batch=TRAIN_BATCH, seed=SEED, device=dev).batch_at(0)
    step_grads = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = vadetect.loss_fn(live, batch, cfg)
        step_grads[tf32] = torch.autograd.grad(loss, leaves(live))
    torch.backends.cudnn.allow_tf32 = tf32_default
    step_tf32 = max(rel_err(a, b)[1]
                    for a, b in zip(step_grads[True], step_grads[False]))
    emit({"phase": "tf32", "batch": TRAIN_BATCH, "layers": tf32_rows,
          "rel_err_port_loss_grads_tf32_allowed_vs_not": step_tf32,
          "tol_port": TF32_RTOL})
    for row in tf32_rows:
        check(max(row["rel_err_port_grad_x"], row["rel_err_port_grad_w"])
              <= TF32_RTOL, f"TF32 in the port's conv backward: {row}")
    check(step_tf32 <= TF32_RTOL, f"TF32 in the loss's gradients: {step_tf32}")

    # the quickstart at full width: train, compile, diagnose, report
    K.launches = SC.launches = QM.launches = BS.launches = 0
    t0 = time.perf_counter()
    qs = quickstart.run(device="cuda")
    torch.cuda.synchronize()
    qs_seconds = time.perf_counter() - t0
    qs_launches = {K.NAME: K.launches, SC.NAME: SC.launches,
                   QM.NAME: QM.launches, BS.NAME: BS.launches}
    expected = {K.NAME: len(layer_problems(va_cnn.CONFIG, vadetect)),
                SC.NAME: 0, QM.NAME: 0, BS.NAME: 0}
    losses = qs["losses"]
    first10, last10 = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    emit({"phase": "quickstart", "entry": "repro_torch.examples.quickstart.run",
          "steps": len(losses), "batch": TRAIN_BATCH,
          "loss_every_50": {i: losses[i] for i in range(0, len(losses), 50)},
          "loss_first10_mean": first10, "loss_last10_mean": last10,
          "accuracy_last10_mean": statistics.mean(qs["accuracies"][-10:]),
          "compiled_kib": qs["compiled_kib"], "compression": qs["compression"],
          "diagnostic_accuracy": f"{qs['correct']}/{qs['patients']}",
          "chip": qs["chip"], "seconds": qs_seconds,
          "launches": qs_launches, "expected_launches": expected})
    check(qs_launches == expected,
          f"quickstart launches {qs_launches}, expected {expected}")
    check(len(losses) == 200 and all(map(math.isfinite, losses)),
          "quickstart losses: not 200 finite values")
    check(last10 < first10, f"quickstart loss did not fall: {first10} -> {last10}")

    # one train step on the card against the same step on the CPU, from
    # warm Adam moments (3 CPU steps first) on the same batch
    cpu = torch.device("cpu")
    step_states = {}
    for cname, cfg in (("CONFIG", va_cnn.CONFIG), ("MIXED", va_cnn.MIXED),
                       ("DENSE", va_cnn.DENSE)):
        opt = optim.adam(3e-3)
        step = trainer.make_train_step(
            lambda p, b, cfg=cfg: vadetect.loss_fn(p, b, cfg), opt, clip_norm=1.0)
        state = trainer.init_state(
            vadetect.init(torch.Generator().manual_seed(SEED), cfg, device=cpu),
            opt, device=cpu)
        stream = iegm.IEGMStream(batch=TRAIN_BATCH, seed=SEED, device=cpu)
        for i in range(3):
            state, _ = step(state, stream.batch_at(i))
        batch = stream.batch_at(3)
        state_d = tree_map(lambda v: v.to(dev), state)
        batch_d = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        new_c, m_c = step(state, batch)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        new_d, m_d = step(state_d, batch_d)
        torch.cuda.synchronize()
        errs = {
            "loss": rel_err(m_d["loss"].cpu(), m_c["loss"])[1],
            "grad_norm": rel_err(m_d["grad_norm"].cpu(), m_c["grad_norm"])[1],
            "params": tree_rel(new_d["params"], new_c["params"], leaves),
            "adam_m": tree_rel(new_d["opt"]["m"], new_c["opt"]["m"], leaves),
            "adam_v": tree_rel(new_d["opt"]["v"], new_c["opt"]["v"], leaves),
        }
        emit({"phase": "train_step", "config": cname, "batch": TRAIN_BATCH,
              "rel_err_card_vs_cpu": errs, "tol": STEP_RTOL,
              "loss": float(m_c["loss"]), "grad_norm": float(m_c["grad_norm"]),
              "cpu_step_wall_ms": cpu_ms})
        check(max(errs.values()) <= STEP_RTOL,
              f"{cname}: card step vs CPU step {errs}")
        check(int(new_d["step"]) == 4, f"{cname}: step count {int(new_d['step'])}")
        step_states[cname] = (step, state_d, batch_d)

    clock("paths")

    # -- the streaming fleet on the card ---------------------------------------
    # nm_spmm against its plain version at the seven sparse layers of the
    # fleet's program, at every bucket a fleet run declares, and its geometry
    fleet_program = stream_fleet.build_program(dev)
    gen_fleet = torch.Generator(device=dev).manual_seed(SEED + 2)
    fleet_err = 0.0
    for bucket in FLEET_KERNEL_BUCKETS:
        for p in layer_problems(va_cnn.CONFIG, vadetect, bucket):
            layer = fleet_program.layers[p["layer"]]
            x = torch.randn((p["m"], p["k"]), generator=gen_fleet, device=dev)
            args = (x, layer.values_q, layer.select, layer.scale)
            y_k = K.nm_spmm_cuda(*args, group_size=16, keep=8)
            torch.cuda.synchronize()
            y_p = K.nm_spmm_plain(*args, group_size=16, keep=8)
            err, rel = rel_err(y_k, y_p)
            fleet_err = max(fleet_err, err)
            emit({"phase": "kernel", "kernel": K.NAME, "bucket": bucket, **p,
                  "max_abs_err": err, "rel_err": rel, "tol": KERNEL_RTOL})
            emit({"phase": "geometry", "kernel": K.NAME, "bucket": bucket, **p,
                  **K.launch_geometry(p["m"], p["k"], p["n"])})
            check(tuple(y_k.shape) == (p["m"], p["n"]), f"fleet {p}: shape")
            check(bool(torch.isfinite(y_k).all()), f"fleet {p}: non-finite")
            check(rel <= KERNEL_RTOL, f"fleet bucket {bucket} {p}: rel err {rel}")

    # the 1000-patient fleet (the example's set-up) through simulate, on
    # each path, its launches counted from 0 (the warm-up classifies each
    # declared bucket once before the timed loop); the kernel path's runner
    # records every bucket's input and logits for the twin comparison below
    fleet_cfg = stream_fleet.fleet_config()
    n_sparse = len(layer_problems(va_cnn.CONFIG, vadetect))
    runners = {"kernel": FleetRunner(fleet_program, path="kernel", device=dev,
                                     record=True),
               "twin": FleetRunner(fleet_program, path="twin", device=dev)}
    fleet, fleet_launches, recorded = {}, None, None
    for path, runner in runners.items():
        K.launches = SC.launches = QM.launches = BS.launches = 0
        out = simulate(stream_fleet.fleet_config(path), runner=runner)
        torch.cuda.synchronize()
        launches = {K.NAME: K.launches, SC.NAME: SC.launches,
                    QM.NAME: QM.launches, BS.NAME: BS.launches}
        m = out["metrics"]
        executes = m["batches_total"] + len(fleet_cfg.buckets)
        expected = {K.NAME: n_sparse * executes if path == "kernel" else 0,
                    SC.NAME: 0, QM.NAME: 0, BS.NAME: 0}
        if path == "kernel":
            fleet_launches = launches[K.NAME]
            recorded, runner.recorded = runner.recorded, None
        emit({"phase": "fleet", "entry": "repro_torch.stream.simulate",
              "path": path, "card": smi, "patients": fleet_cfg.n_patients,
              "buckets": list(fleet_cfg.buckets), "launches": launches,
              "expected_launches": expected,
              "segments_per_s_wall": m["segments_per_s_wall"],
              "realtime_factor": out["realtime"]["realtime_factor"],
              "wall_s": m["wall_s"],
              "counts": {k: m[k] for k in FLEET_COUNTS},
              "deadline_slack_s": m.get("deadline_slack_s"),
              "jit_cache_misses": out["jit_cache_misses"],
              "accuracy": out["accuracy"], "chip_model": out["chip"]})
        check(launches == expected,
              f"fleet {path}: launches {launches}, expected {expected}")
        check(m["dropped_total"] == 0, f"fleet {path}: dropped {m['dropped_total']}")
        check(out["realtime"]["realtime_factor"] >= 1.0,
              f"fleet {path}: real-time factor {out['realtime']['realtime_factor']}")
        check(out["jit_cache_misses"] == len(fleet_cfg.buckets),
              f"fleet {path}: {out['jit_cache_misses']} bucket shapes")
        check(m["segments_total"] == fleet_cfg.n_patients * 6,
              f"fleet {path}: {m['segments_total']} segments")
        fleet[path] = out
    counts = {p: {k: fleet[p]["metrics"][k] for k in FLEET_COUNTS} for p in fleet}
    check(counts["kernel"] == counts["twin"], f"fleet counts differ: {counts}")

    # every kernel-path bucket's logits against the twin path's on the same
    # input; every row is compared (a padding row repeats its batch's last
    # valid row)
    by_bucket, flips, flip_margin = {}, 0, 0.0
    for x, y_k in recorded[len(fleet_cfg.buckets):]:  # after the warm-up
        y_t = runners["twin"].logits(x)
        err = float((y_k - y_t).abs().max())
        by_bucket[len(x)] = max(by_bucket.get(len(x), 0.0), err)
        flip = y_k.argmax(-1) != y_t.argmax(-1)
        margin = (y_t[:, 1] - y_t[:, 0]).abs()[flip]
        flips += int(flip.sum())
        if margin.numel():
            flip_margin = max(flip_margin, float(margin.max()))
    emit({"phase": "fleet_paths", "card": smi,
          "buckets_compared": len(recorded) - len(fleet_cfg.buckets),
          "max_abs_err_logits_kernel_vs_twin_by_bucket": by_bucket,
          "flip_rows": flips, "flip_twin_margin_max": flip_margin,
          "tol": LOGITS_TOL})
    check(max(by_bucket.values()) <= LOGITS_TOL,
          f"fleet logits kernel vs twin: {by_bucket}")
    check(flip_margin < LOGITS_TOL,
          f"a fleet prediction flipped at twin margin {flip_margin}")

    # FLEET_REPS more runs a path on the same runners, in turns (kernel,
    # twin, twin, kernel, ...): all but the last for the spread of the
    # loop's wall, the last with telemetry enabled for where its time goes
    # (the spans: classify and vote are dispatch; the rest of the flush is
    # the bank gather, the wait for the card and the copy back)
    rates = {p: [fleet[p]["metrics"]["segments_per_s_wall"]] for p in fleet}
    for rep in range(FLEET_REPS):
        traced = rep == FLEET_REPS - 1
        for path in (("kernel", "twin") if rep % 2 == 0 else ("twin", "kernel")):
            if traced:
                tel = obs.configure(enabled=True)
            out = simulate(stream_fleet.fleet_config(path), runner=runners[path])
            m = out["metrics"]
            check(m["dropped_total"] == 0, f"fleet {path}: drops")
            if not traced:
                rates[path].append(m["segments_per_s_wall"])
                continue
            span_s = {}
            for e in tel.tracer.events():
                if e["type"] == "span":
                    span_s[e["name"]] = span_s.get(e["name"], 0.0) + e["dur_us"] / 1e6
            obs.reset()
            pack, flush = span_s["stream/pack"], span_s["stream/flush"]
            classify, vote = span_s["stream/classify"], span_s["stream/vote"]
            emit({"phase": "fleet_split", "path": path, "card": smi,
                  "telemetry": "enabled", "wall_s": m["wall_s"],
                  "segments_per_s_wall": m["segments_per_s_wall"],
                  "realtime_factor": out["realtime"]["realtime_factor"],
                  "batches": m["batches_total"], "pack_s": pack,
                  "flush_s": flush, "classify_dispatch_s": classify,
                  "vote_dispatch_s": vote,
                  "flush_gather_wait_copy_s": flush - classify - vote,
                  "outside_spans_s": m["wall_s"] - pack - flush})
    emit({"phase": "fleet_reps", "card": smi, "runs_per_path": FLEET_REPS,
          "segments_per_s_wall": rates,
          "median": {p: statistics.median(r) for p, r in rates.items()},
          "realtime_factor_median": {
              p: statistics.median(r) * fleet_cfg.period_s / fleet_cfg.n_patients
              for p, r in rates.items()}})

    # the throughput benchmark in its smoke form; its checks stand
    rec = stream_throughput.run(smoke=True, device="cuda")
    obs.reset()
    emit({"phase": "stream_throughput",
          "entry": "repro_torch.benchmarks.stream_throughput.run(smoke=True)",
          "card": smi, "cells": rec["cells"],
          "realtime_1000_patients": rec["realtime_1000_patients"],
          "overhead": rec["telemetry"]["overhead"],
          "recompiles": rec["telemetry"]["recompiles"],
          "peak_device_memory_bytes": rec["telemetry"]["peak_device_memory_bytes"]})

    clock("fleet")

    # -- 4. times -------------------------------------------------------------
    # the floor of device_ms: one launch that does next to no work
    one = torch.zeros(1, device=dev)
    emit({"phase": "time", "floor": "one-element add_",
          "ms": device_ms(torch, lambda: one.add_(1.0)),
          "ms_in_run": run_ms(torch, lambda: one.add_(1.0))[0]})
    program = timed["CONFIG"][0]
    # ms_in_run per launch in a run of RUN_LAUNCHES behind a sleep
    run_sleep_ms = device_ms(torch, lambda: torch.cuda._sleep(RUN_SLEEP_CYCLES))
    enqueue_max = 0.0

    def in_run(run: dict) -> dict:
        """ms_in_run of the kernel and the library call in `run`."""
        nonlocal enqueue_max
        got = {key: run_ms(torch, fn) for key, fn in run.items()}
        enqueue_max = max([enqueue_max] + [e for _, e in got.values()])
        return {"ms_in_run": got["kernel"][0],
                "library_ms_in_run": got["library"][0]}

    spe_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ms_in_run",
                "library_ms_in_run", "tc_bound_ms")
    totals = dict.fromkeys(spe_keys, 0.0)
    bytes_ms = ops_ms = 0.0
    for p, name in zip(problems, [m["name"] for m in program.layer_meta]):
        layer = program.layers[name]
        x = torch.randn((p["m"], p["k"]), generator=gen_dev, device=dev)
        args = (x, layer.values_q, layer.select, layer.scale)
        w_dense = decompress_tile(layer.values_q, layer.select, 16, 8) * layer.scale
        run = {"kernel": lambda: K.nm_spmm_cuda(*args, group_size=16, keep=8),
               "library": lambda: torch.matmul(x, w_dense)}
        t = {
            "ms": device_ms(torch, run["kernel"]),
            "plain_ms": device_ms(torch, lambda: K.nm_spmm_plain(*args, group_size=16, keep=8)),
            "library_ms": device_ms(torch, run["library"]),
            **in_run(run),
        }
        b_ms, o_ms = bound(p["m"], p["k"], p["kk"], p["n"])
        t["bound_ms"] = max(b_ms, o_ms)
        t["tc_bound_ms"] = spe_tc_bound_ms(b_ms, p["m"], p["k"], p["n"])
        bytes_ms, ops_ms = bytes_ms + b_ms, ops_ms + o_ms
        for key in totals:
            totals[key] += t[key]
        emit({"phase": "time", "kernel": K.NAME, **p, **t,
              "bound_by": "bytes" if b_ms >= o_ms else "operations"})
    conv_totals = dict.fromkeys(spe_keys + ("im2col_nm_spmm_ms",), 0.0)
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

        run = {"kernel": lambda: SC.sparse_conv1d_cuda(*args, **kw),
               "library": lambda: spe.conv1d_same(x, w_conv, stride)}
        t = {
            "ms": device_ms(torch, run["kernel"]),
            "plain_ms": device_ms(torch, lambda: SC.sparse_conv1d_plain(*args, **kw)),
            "library_ms": device_ms(torch, run["library"]),
            "im2col_nm_spmm_ms": device_ms(torch, im2col_nm_spmm),
            **in_run(run),
        }
        kk = layer.values_q.shape[0]
        rows_d = (torch.arange(kk, device=dev) // 8)[:, None] * 16 + layer.select.long()
        valid = int((rows_d < ks * c).sum())
        b_ms, o_ms = conv_bound(x, n, kk, valid, m["t_out"])
        t["bound_ms"] = max(b_ms, o_ms)
        t["tc_bound_ms"] = spe_tc_bound_ms(b_ms, BUCKET * m["t_out"],
                                           layer.k_dense, n)
        conv_bytes_ms, conv_ops_ms = conv_bytes_ms + b_ms, conv_ops_ms + o_ms
        for key in conv_totals:
            conv_totals[key] += t[key]
        emit({"phase": "time", "kernel": SC.NAME, "layer": m["name"],
              "x": list(x.shape), "n": n, "ksize": ks, "stride": stride,
              "kk": kk, "valid_weights": valid, **t,
              "bound_by": "bytes" if b_ms >= o_ms else "operations"})

    # quant_matmul, then bitserial_matmul, at every width at the benchmark
    # shape (their sums go into the kernels line), then at the large shape
    cmul_fns = {QM.NAME: (QM.quant_matmul_cuda, QM.quant_matmul_plain),
                BS.NAME: (BS.bitserial_matmul_cuda, BS.bitserial_matmul_plain)}
    cmul_totals, cmul_bound_by = {}, {}
    timed_cases = [(name, bits, (bench.M, bench.K, bench.N), gen_dev)
                   for name in cmul_fns for bits in BS.BITS]
    timed_cases += [(name, bits, LARGE, gen_large)
                    for name in cmul_fns for bits in LARGE_BITS]
    for name, bits, (m_q, k_q, n_q), g in timed_cases:
        kernel_fn, plain_fn = cmul_fns[name]
        w = torch.randn((k_q, n_q), generator=g, device=dev)
        q, sc = quant.quantize(w, quant.QuantConfig(bits=bits))
        packed = quant.pack_planes(q, bits)
        x = torch.randn((m_q, k_q), generator=g, device=dev)
        w_deq = unpack_tile(packed, bits).to(torch.float32) * sc
        run = {"kernel": lambda: kernel_fn(x, packed, sc, bits=bits),
               "library": lambda: torch.matmul(x, w_deq)}
        t = {
            "ms": device_ms(torch, run["kernel"]),
            "plain_ms": device_ms(torch, lambda: plain_fn(x, packed, sc, bits=bits)),
            "library_ms": device_ms(torch, run["library"]),
            **in_run(run),
        }
        b_ms, o_ms = quant_bound(m_q, k_q, n_q, packed.numel())
        t["bound_ms"] = max(b_ms, o_ms)
        t["tc_bound_ms"] = tc_bound_ms(m_q, k_q, n_q, packed.numel())
        emit({"phase": "time", "kernel": name, "bits": bits, "m": m_q,
              "k": k_q, "n": n_q, **t,
              "bound_by": "bytes" if b_ms >= o_ms else "operations"})
        if (m_q, k_q, n_q) == LARGE:
            continue
        totals_k = cmul_totals.setdefault(name, dict.fromkeys(t, 0.0))
        for key in t:
            totals_k[key] += t[key]
        by = cmul_bound_by.setdefault(name, [0.0, 0.0])
        by[0], by[1] = by[0] + b_ms, by[1] + o_ms
    # false would mean that some ms_in_run also counts the host's enqueue
    emit({"phase": "time", "ms_in_run_sleep_ms": run_sleep_ms,
          "ms_in_run_enqueue_ms_max": enqueue_max,
          "enqueue_covered_by_sleep": enqueue_max < run_sleep_ms})

    # one bucket through each path: its device time behind a sleep long
    # enough to cover the host's enqueue of the whole call (about 60 small
    # ops, a few milliseconds at most; the run's sleep, run_sleep_ms);
    # CONFIG and MIXED on the kernel and the dense ("twin") path, CONFIG
    # also on the reference path
    signals = iegm.synth_batch(gen, BUCKET, device=dev)["signal"]
    for cname, path in (("CONFIG", "kernel"), ("CONFIG", "reference"),
                        ("CONFIG", "twin"), ("MIXED", "kernel"),
                        ("MIXED", "twin")):
        prog, cfg = timed[cname]
        runner = FleetRunner(prog, cfg, path=path, device=dev)
        enqueue = []
        emit({"phase": "time", "execute": path, "config": cname,
              "bucket": BUCKET,
              "device_ms": device_ms(torch, lambda: runner.logits(signals),
                                     RUN_SLEEP_CYCLES, enqueue),
              "wall_ms": wall_ms(torch, lambda: runner.logits(signals)),
              "enqueue_ms_max": max(enqueue),
              "enqueue_covered_by_sleep": max(enqueue) < run_sleep_ms})

    # the fleet's program at each bucket of the example's ladder, on both
    # fleet paths
    for bucket in fleet_cfg.buckets:
        signals = iegm.synth_batch(gen, bucket, device=dev)["signal"]
        for path in ("kernel", "twin"):
            runner = FleetRunner(fleet_program, path=path, device=dev)
            enqueue = []
            emit({"phase": "time", "execute": path, "config": "fleet",
                  "bucket": bucket, "card": smi,
                  "device_ms": device_ms(torch, lambda: runner.logits(signals),
                                         RUN_SLEEP_CYCLES, enqueue),
                  "wall_ms": wall_ms(torch, lambda: runner.logits(signals)),
                  "enqueue_ms_max": max(enqueue),
                  "enqueue_covered_by_sleep": max(enqueue) < run_sleep_ms})

    # one train step of the quickstart (CONFIG, adam, batch 64): host time
    # through a synchronize, and device time behind a sleep long enough to
    # cover the host's enqueue of the whole step (it never waits on the
    # card), so the device's busy share of a step is device / wall
    sleep_ms = device_ms(torch, lambda: torch.cuda._sleep(STEP_SLEEP_CYCLES))
    for cname, (step, state_d, batch_d) in step_states.items():
        enqueue = []
        t = {
            "wall_ms": wall_ms(torch, lambda: step(state_d, batch_d)),
            "device_ms": device_ms(torch, lambda: step(state_d, batch_d),
                                   STEP_SLEEP_CYCLES, enqueue),
        }
        emit({"phase": "time", "train_step": cname, "batch": TRAIN_BATCH, **t,
              "device_busy_share": t["device_ms"] / t["wall_ms"],
              "enqueue_ms_max": max(enqueue), "sleep_ms": sleep_ms,
              "enqueue_covered_by_sleep": max(enqueue) < sleep_ms})

    # where a CONFIG step's time goes: a profiler trace of PROFILE_STEPS
    # steps — kernels launched per step and device time by kernel name
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step, state_d, batch_d = step_states["CONFIG"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            step(state_d, batch_d)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    on_card = [e for e in averages if e.device_type == DeviceType.CUDA]
    top = sorted(on_card, key=lambda e: e.device_time_total, reverse=True)
    emit({"phase": "profile", "train_step": "CONFIG", "steps": PROFILE_STEPS,
          "kernels_per_step": sum(e.count for e in on_card) / PROFILE_STEPS,
          "device_ms_per_step": sum(e.device_time_total for e in on_card)
          / PROFILE_STEPS / 1e3,
          "launch_calls_per_step": sum(
              e.count for e in averages if e.key.startswith("cudaLaunchKernel"))
          / PROFILE_STEPS,
          "top_kernels": [{"name": e.key[:80], "count": e.count,
                           "device_ms": e.device_time_total / 1e3}
                          for e in top[:8]]})

    clock("time")
    check(not any(m == "jax" or m.startswith(("jax.", "repro."))
                  or m == "repro" for m in sys.modules),
          "jax or the JAX package was imported")
    emit({"kernels": [{
        "name": K.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/nm_spmm.cu",
        "replaces": "src/repro/kernels/nm_spmm.py:68",
        "launches": fleet_launches, "launches_service": main_launches,
        "max_abs_err": max(max_abs_err, fleet_err),
        **{key: totals[key] for key in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        **{key: totals[key] for key in
           ("library_ms", "ms_in_run", "library_ms_in_run", "tc_bound_ms")},
        "at": "sum of the 7 sparse VA layers at bucket 256; launches over "
              "the 1000-patient fleet's kernel-path run (launches_service: "
              "over the service run)",
    }, {
        "name": SC.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sparse_conv1d.cu",
        "replaces": "src/repro/kernels/sparse_conv1d.py:64",
        "launches": bench_launches[SC.NAME], "max_abs_err": conv_err,
        **{key: conv_totals[key] for key in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes" if conv_bytes_ms >= conv_ops_ms else "operations",
        **{key: conv_totals[key] for key in
           ("library_ms", "ms_in_run", "library_ms_in_run", "tc_bound_ms",
            "im2col_nm_spmm_ms")},
        "at": "sum of the 7 sparse VA layers at bucket 256; launches over "
              "the benchmark run",
    }] + [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        **{key: cmul_totals[name][key] for key in
           ("ms", "plain_ms", "bound_ms")},
        "bound_by": ("bytes" if cmul_bound_by[name][0] >= cmul_bound_by[name][1]
                     else "operations"),
        **{key: cmul_totals[name][key] for key in
           ("library_ms", "ms_in_run", "library_ms_in_run", "tc_bound_ms")},
        "at": "sum of 8/4/2/1 bits at the benchmark shape (128, 512, 256); "
              f"launches over {over}",
    } for name, replaces, launches, err, over in (
        (QM.NAME, "src/repro/kernels/quant_matmul.py:42",
         bench_launches[QM.NAME], quant_err, "the benchmark run"),
        (BS.NAME, "src/repro/kernels/bitserial.py:67",
         sweep_launches[BS.NAME], bs_err, "the CMUL sweep"),
    )]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

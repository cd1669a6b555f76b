"""PyTorch port vs JAX package on the serving slice: band-pass, the
bucketed FleetRunner and the VA diagnosis service — plus the port's
boundaries (no jax, no silent CPU fallback).

Both packages get the same compiled program (the JAX compiler's output
carried across with `convert.program_from_numpy`) and the same numpy
records. Predictions and diagnoses must be identical; the band-pass is a
float32 convolution summed in another order, held to 1e-5.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import CPU, configs, n, np_params, np_signals, program_arrays, t

from repro.core import compiler as jc
from repro.data import iegm as jiegm
from repro.serve import va_service as jsvc
from repro.stream import runner as jrunner
from repro_torch import convert, optim
from repro_torch.benchmarks import kernels as bench_kernels
from repro_torch.core import compiler as tc
from repro_torch.core import vadetect as tva
from repro_torch.data import iegm as tiegm
from repro_torch.configs import reduced as reduced_config
from repro_torch.examples import quickstart, serve_lm
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import stream as tstream
from repro_torch.models import api as tapi
from repro_torch.serve import engine as tengine
from repro_torch.serve import va_service as tsvc
from repro_torch.stream import runner as trunner
from repro_torch.train import trainer as ttrainer

REPO = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _programs():
    """(jax cfg, port cfg, jax program, the same program in the port)."""
    cfg_j, cfg_t = configs(False)
    tree = np_params(cfg_t.layers, 11)
    params_j = {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in tree.items()}
    prog_j = jc.compile_model(params_j, cfg_j)
    prog_t = convert.program_from_numpy(*program_arrays(prog_j), device=CPU)
    return cfg_j, cfg_t, prog_j, prog_t


def test_bandpass_matches_jax():
    np.testing.assert_array_equal(tiegm.bandpass_taps(), jiegm.bandpass_taps())
    x = np_signals(3, 4)
    y_t = n(tiegm.bandpass(t(x)))
    y_j = n(jiegm.bandpass(jnp.asarray(x)))
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=1e-5)


def test_program_from_numpy_equals_port_compile():
    """Carrying the JAX program across equals compiling in the port."""
    _, cfg_t, prog_j, prog_t = _programs()
    tree = np_params(cfg_t.layers, 11)
    own = tc.compile_model(convert.params_from_numpy(tree, device=CPU), cfg_t)
    for name, layer in own.layers.items():
        for field in ("values_q", "select", "scale", "packed_planes"):
            np.testing.assert_array_equal(
                n(getattr(prog_t.layers[name], field)), n(getattr(layer, field))
            )
    assert prog_t.report == own.report


def test_fleet_runner_paths_match_jax():
    cfg_j, cfg_t, prog_j, prog_t = _programs()
    x = np_signals(8, 12)
    want = n(jrunner.FleetRunner(prog_j, cfg_j, path="twin").classify(jnp.asarray(x)))
    logits_j = n(jax.jit(lambda v: jc.execute(prog_j, v, cfg_j))(x))
    for path in ("twin", "kernel", "reference"):
        runner = trunner.FleetRunner(prog_t, cfg_t, path=path, device="cpu")
        got = n(runner.classify(t(x)))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=path)
        # float32, summed in another order
        np.testing.assert_allclose(n(runner.logits(t(x))), logits_j,
                                   rtol=1e-4, atol=1e-4, err_msg=path)
    jr = jrunner.FleetRunner(prog_j, cfg_j)
    assert runner.chip_latency_s == jr.chip_latency_s
    assert runner.batch_service_s(8) == jr.batch_service_s(8)
    assert runner.modeled_segments_per_s() == jr.modeled_segments_per_s()


@pytest.mark.parametrize("path", ["kernel", "twin"])
def test_va_service_diagnoses_match_jax(path):
    cfg_j, cfg_t, prog_j, prog_t = _programs()
    recs = np_signals(3, 13, segments=6)  # 18 segments -> bucket 32
    want = jsvc.VAService(prog_j, cfg_j, path="reference").diagnose_batch(
        jnp.asarray(recs)
    )
    got = tsvc.VAService(prog_t, cfg_t, path=path, device="cpu").diagnose_batch(t(recs))
    assert got == [
        tsvc.Diagnosis(d.patient, d.is_va, d.segment_preds, d.chip_latency_us)
        for d in want
    ]
    assert tsvc._bucket_for(18) == jsvc._bucket_for(18) == 32


def test_synth_batches_are_seeded():
    a = tiegm.synth_diagnosis_batch(torch.Generator().manual_seed(3), 2, device="cpu")
    b = tiegm.synth_diagnosis_batch(torch.Generator().manual_seed(3), 2, device="cpu")
    assert a["signal"].shape == (2, 6, 512) and a["label"].shape == (2,)
    torch.testing.assert_close(a["signal"], b["signal"], rtol=0, atol=0)
    assert bool(torch.isfinite(a["signal"]).all())
    s = tiegm.synth_batch(torch.Generator().manual_seed(4), 16, device="cpu")
    assert s["signal"].shape == (16, 512) and s["label"].dtype == torch.int32
    # normalized per record (the front end's AGC)
    torch.testing.assert_close(
        s["signal"].std(dim=1, correction=0), torch.ones(16), rtol=1e-4, atol=1e-4
    )


def test_port_imports_no_jax():
    """The port's serving path, its kernel benchmark, the CMUL, the
    training path, the LM substrate and its serving, and the serving
    frontend with its launchers, and the distributed pieces (sharding
    rules, compression, meshes, the multi-pod trainer's launcher, the
    dist and stream benchmarks, sharded serving) import neither jax nor
    anything of the JAX
    package (checked in a fresh interpreter: this
    one has jax)."""
    code = (
        "import sys, repro_torch.serve.va_service, repro_torch.convert, "
        "repro_torch.configs.va_cnn, repro_torch.data.iegm, "
        "repro_torch.kernels.ops, repro_torch.kernels.sparse_conv1d, "
        "repro_torch.kernels.quant_matmul, repro_torch.benchmarks.kernels, "
        "repro_torch.kernels.bitserial, repro_torch.optim, "
        "repro_torch.dist.accumulate, repro_torch.train.trainer, "
        "repro_torch.examples.quickstart, repro_torch.configs, "
        "repro_torch.models.layers, repro_torch.models.attention, "
        "repro_torch.models.transformer, repro_torch.models.api, "
        "repro_torch.serve.engine, repro_torch.serve.seating, "
        "repro_torch.serve.paging, repro_torch.launch.serve, "
        "repro_torch.examples.serve_lm, repro_torch.serve.frontend, "
        "repro_torch.obs.loadlab, repro_torch.launch.stream, "
        "repro_torch.dist.sharding, repro_torch.dist.compression, "
        "repro_torch.launch.mesh, repro_torch.launch.train, "
        "repro_torch.benchmarks.dist_compression, "
        "repro_torch.benchmarks.stream_throughput, "
        "repro_torch.serve.sharded\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def lm_model():
    return tapi.build_model(reduced_config("qwen3_8b"), max_seq=8)


@pytest.mark.parametrize(
    "entry", ["init", "synth", "params", "runner", "service", "benchmark",
              "stream", "trainer", "state", "quickstart", "lm_init",
              "lm_params", "generate", "engine", "launch_serve",
              "serve_lm_example", "launch_serve_listen", "launch_stream"]
)
def test_default_device_raises_without_a_card(entry):
    """`device=None` means the CUDA card; with none present an entry
    point raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, cfg_t, _, prog_t = _programs()
    calls = {
        "init": lambda: tva.init(torch.Generator().manual_seed(0)),
        "synth": lambda: tiegm.synth_batch(torch.Generator().manual_seed(0), 2),
        "params": lambda: convert.params_from_numpy(np_params(cfg_t.layers, 0)),
        "runner": lambda: trunner.FleetRunner(prog_t, cfg_t, path="kernel"),
        "service": lambda: tsvc.VAService(prog_t, cfg_t, path="kernel"),
        "benchmark": lambda: bench_kernels.run(),
        "stream": lambda: tiegm.IEGMStream(batch=2),
        "trainer": lambda: ttrainer.init_state(
            convert.params_from_numpy(np_params(cfg_t.layers, 0), device=CPU),
            optim.adam(3e-3)),
        "state": lambda: convert.state_from_numpy(
            {"params": np_params(cfg_t.layers, 0), "opt": {}, "step": 0}),
        "quickstart": lambda: quickstart.run(steps=1),
        "lm_init": lambda: lm_model().init(0),
        "lm_params": lambda: convert.lm_params_from_numpy(
            {"embed": {"w": np.zeros((4, 2), np.float32)}}),
        "generate": lambda: tengine.generate(
            lm_model(), lm_model().init(0, device=CPU),
            torch.zeros((1, 3), dtype=torch.long), max_new=1),
        "engine": lambda: tengine.Engine(
            lm_model(), lm_model().init(0, device=CPU), batch_size=1),
        "launch_serve": lambda: tlaunch.main(
            ["--arch", "qwen3-8b", "--reduced"]),
        "serve_lm_example": lambda: serve_lm.main(["--smoke"]),
        "launch_serve_listen": lambda: tlaunch.main(
            ["--arch", "qwen3-8b", "--reduced", "--listen", "127.0.0.1:0"]),
        "launch_stream": lambda: tstream.main(["--patients", "4"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()

"""PyTorch port vs JAX package: the paper's benchmarks and examples —
`repro_torch.benchmarks.{table1, ablation, run}` and
`repro_torch.examples.{va_inference_demo, train_va}` — on the CPU.

table1's derived strings equal the reference's (the µs column is
timing). The ablation's storage columns are the compiler's: on the same
numpy parameters they equal the reference's exactly. Its accuracies come
from the port's own batches (torch cannot reproduce `jax.random`), so
they are held to be finite. The examples run at a few steps; each
checks what the reference prints.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import CPU, NARROW, np_params

from repro.core import compiler as jcompiler
from repro.core import spe as jspe
from repro.core import vadetect as jva
from repro_torch import convert
from repro_torch.benchmarks import ablation, kernels, run, table1
from repro_torch.core import vadetect as tva
from repro_torch.examples import train_va, va_inference_demo

_ROW = re.compile(r"^[\w.]+,[0-9.]+,.+$")


def _import_reference_table1():
    """benchmarks/table1.py of the JAX package, by path (the repository
    root is not a package on the test path)."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "table1.py")
    spec = importlib.util.spec_from_file_location("_ref_table1", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_table1_rows_equal_the_reference():
    got = table1.run()
    want = _import_reference_table1().run()
    assert [r[0] for r in got] == [r[0] for r in want] == [
        "table1.latency_us", "table1.effective_GOPS", "table1.avg_power_uW",
        "table1.power_density_uW_mm2", "table1.density_improvement_x"]
    assert [r[2] for r in got] == [r[2] for r in want]
    assert "model=10.60 paper=10.6" in got[2][2]


def test_ablation_runs_five_points_on_the_cpu():
    rows = ablation.run(steps=3, device="cpu")
    assert [r[0] for r in rows] == [f"ablation.{name}"
                                    for name, _ in ablation.POINTS]
    for name, us, derived in rows:
        m = re.fullmatch(r"acc=([0-9.]+) weights_kb=([0-9.]+) "
                         r"compress=([0-9.]+)x", derived)
        assert m, derived
        assert np.isfinite(float(m.group(1))) and us > 0
    assert rows[0][2].endswith("compress=1.00x")


def _jspe(spe):
    if spe is None:
        return None
    return jspe.SPEConfig(bits=spe.bits, group_size=spe.group_size,
                          keep=spe.keep, sparse=spe.sparse,
                          quantized=spe.quantized)


@pytest.mark.parametrize("name,spe", ablation.POINTS,
                         ids=[name for name, _ in ablation.POINTS])
def test_ablation_storage_equals_the_reference(name, spe):
    """The same numpy params of the narrow stack (its first layer's K, 28,
    padded to whole groups): the port's weights_kb and compression equal
    the reference's compiled program's."""
    params = np_params(NARROW, 3)
    tcfg = tva.VAConfig(layers=NARROW, spe=spe)
    kb, ratio = ablation.storage(convert.params_from_numpy(params, CPU), tcfg)
    if spe is not None and spe.quantized:
        prog = jcompiler.compile_model(
            jax.tree.map(jnp.asarray, params),
            jva.VAConfig(layers=NARROW, spe=_jspe(spe)))
        want = prog.weight_hbm_bytes() / 1024, prog.compression_ratio()
    else:
        n = sum(a.size for layer in params.values() for a in layer.values())
        want = n * 4 / 1024, 1.0
    assert (kb, ratio) == want


def test_va_inference_demo_runs_on_the_cpu(capsys):
    out = va_inference_demo.main(device="cpu", steps=3)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert [ln.split()[0] for ln in lines] == [
        "paper_8bit", "mixed_8_4bit", "dense_float"]
    for ln in lines[:2]:
        assert ln.endswith("kernel_argmax_agree=1.00"), ln
    assert lines[2].endswith("(f32 baseline)")
    assert [r["kernel_argmax_agree"] for r in out[:2]] == [1.0, 1.0]
    assert out[0]["power_uW"] == pytest.approx(10.60, abs=0.01)


def test_train_va_checkpoints_and_resumes_on_the_cpu(tmp_path, monkeypatch,
                                                     capsys):
    """6 steps, then a second call to 8 on the same directory resumes at
    6. The evaluation is cut to 8 patients (256 on the reference path
    take seconds on the CPU)."""
    monkeypatch.setattr(train_va, "evaluate",
                        functools.partial(train_va.evaluate, patients=8))
    ck = str(tmp_path)
    argv = ["--batch", "8", "--ckpt", ck]
    first = train_va.main(["--steps", "6", *argv], device="cpu")
    assert [h["step"] for h in first["history"]] == list(range(6))
    assert open(os.path.join(ck, "LATEST")).read() == "6"
    second = train_va.main(["--steps", "8", *argv], device="cpu")
    assert [h["step"] for h in second["history"]] == [6, 7]
    assert open(os.path.join(ck, "LATEST")).read() == "8"
    assert sorted(os.listdir(ck)) == ["LATEST", "step_00000006",
                                      "step_00000008"]
    for key in ("segment_acc", "diagnostic_acc", "precision", "recall"):
        assert 0.0 <= second[key] <= 1.0
    printed = capsys.readouterr().out
    assert "model: 51290 params, 8 conv layers" in printed
    assert "stragglers flagged: " in printed and "this run " in printed
    assert "chip model: 35.0 us" in printed


def test_run_prints_the_three_sections(monkeypatch, capsys, tmp_path):
    """The paper's three sections, then the roofline summary's row (no
    dry-run records: `roofline.missing`)."""
    from repro_torch.benchmarks import roofline_summary

    monkeypatch.setattr(ablation, "run",
                        functools.partial(ablation.run, steps=1))
    monkeypatch.setattr(roofline_summary, "DRYRUN_DIR",
                        str(tmp_path / "none"))
    run.main(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    names = [ln.split(",")[0] for ln in lines[1:]]
    assert all(_ROW.match(ln) for ln in lines[1:]), lines
    assert names == (
        [r[0] for r in table1.run()]
        + ["kernels.nm_spmm"]
        + [f"kernels.quant_matmul_{b}b" for b in (8, 4, 2, 1)]
        + ["kernels.sparse_conv1d"]
        + [f"ablation.{name}" for name, _ in ablation.POINTS]
        + ["roofline.missing"])


def test_run_exits_1_when_a_section_fails(monkeypatch, capsys):
    def broken(device):
        raise RuntimeError("kernel section broke")

    monkeypatch.setattr(kernels, "run", broken)
    monkeypatch.setattr(ablation, "run", lambda device: [])
    with pytest.raises(SystemExit) as e:
        run.main(device="cpu")
    assert e.value.code == 1
    err = capsys.readouterr().err
    assert "repro_torch.benchmarks.kernels,nan,FAILED" in err


@pytest.mark.parametrize("entry", ["train_va", "ablation", "demo",
                                   "demo_train", "run", "evaluate"])
def test_default_device_raises_without_a_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    calls = {
        "train_va": lambda: train_va.main(["--steps", "1", "--ckpt",
                                           str(tmp_path)]),
        "ablation": lambda: ablation.run(steps=1),
        "demo": lambda: va_inference_demo.main(steps=1),
        "demo_train": lambda: va_inference_demo.train(tva.VAConfig(), 1),
        "run": run.main,
        "evaluate": lambda: train_va.evaluate(None, tva.VAConfig()),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()

"""The dry-run's port (`repro_torch.launch.{dryrun, op_count,
op_analysis, hillclimb}`) against the reference's `repro.launch.dryrun`,
on the CPU with `device="cpu"`.

The reference's side runs in one subprocess with 4 forced host devices
(`tests/_dist_reference.py dryrun`): `count_params` / `model_flops` of
every `CLI_IDS` arch and applicable shape, and `lower_cell` + `analyze`
of the reduced qwen3-8b's decode, prefill and train cells (batch 8,
sequence 64) on a 2x2 mesh. The port counts the same cells on fake
tensors as rank 0 of a 4-rank fake process group, which a module fixture
brings up and takes down.

Equal: N_total / N_active and MODEL_FLOPS; each cell's argument bytes
a device, MODEL_FLOPS, device count and mesh; each placed leaf's bytes a
device (the train state leaf by leaf: the port's ZeRO-1 placement holds
the same blocks as the reference's shardings). Collective counts are not
compared: XLA inserts collectives of its own when it reshards
(`collective-permute`, `all-to-all`), which an eager program never
issues; the decode step stays within `_decode_comm_budget`.

Also pinned: a fake step's counts equal a real call's (the cell
auditor's recorder; the card's route, with the kernel's work out of the
recorder's sight as `ctypes` leaves it), each kernel wrapper on a fake tensor (shape, dtype,
device, the real launch's reported cost, no plain version, no launch),
`MemTracker`'s peak against a closed form, and `hillclimb --variant w8`.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch import configs
from repro_torch.configs.base import applicable_shapes
from repro_torch.kernels import bitserial as BS
from repro_torch.kernels import nm_spmm as NM
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as QM
from repro_torch.kernels import sparse_conv1d as SC
from repro_torch.launch import dryrun, hillclimb, op_count
from repro_torch.models import api
from repro_torch.obs import torchprobe
from repro_torch.serve.engine import quantize_for_serving
from repro_torch.serve.sharded import _decode_comm_budget

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 59
CELLS = ("decode_32k", "prefill_32k", "train_4k")
CELL_ARGS = ["--arch", "qwen3-8b", "--reduced", "--batch", "8", "--seq",
             "64", "--mesh-shape", "2x2", "--device", "cpu"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's accounting (`_dist_reference.py dryrun`), started
    at once; the JSON it writes."""
    out = tmp_path_factory.mktemp("ref_dryrun") / "ref.json"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(REPO / "src")}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_dist_reference.py"),
         "dryrun", str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)

    def get() -> dict:
        if not out.exists():
            log, _ = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, log[-3000:]
        return json.loads(out.read_text())

    yield get
    proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def cells(reference, tmp_path_factory):
    """The port's records of the three reduced cells on a fake 2x2, made
    while the reference's subprocess runs (the fake group taken down
    after the module)."""
    out = tmp_path_factory.mktemp("dryrun")
    try:
        recs = {}
        for shape in CELLS:
            recs[shape] = dryrun.main(
                CELL_ARGS + ["--shape", shape, "--out", str(out)])[0]
        yield recs, out
    finally:
        dryrun.close_fake_world()


def _leaf_bytes(prefix: str, tree, out: dict) -> dict:
    """path -> bytes of each tensor leaf of a nested dict (this rank's
    blocks)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _leaf_bytes(f"{prefix}/{k}", v, out)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.numel() * tree.element_size()
    return out


@pytest.mark.parametrize("shape", CELLS)
def test_reduced_cells_account_as_the_references(reference, cells, shape):
    """argument bytes a device, MODEL_FLOPS, device count and mesh equal
    the reference's `analyze` of the same cell (decode 105 248 argument
    bytes); each placed leaf's bytes equal its block under the
    reference's compiled input shardings."""
    recs, _ = cells
    rec, want = recs[shape], reference()["cells"][shape]
    for key in ("n_devices", "mesh"):
        assert rec[key] == want[key], key
    assert rec["memory"]["argument_bytes"] == want["argument_bytes"]
    assert (rec["roofline"]["model_flops_total"]
            == want["model_flops_total"])
    assert rec["memory"]["bf16_emulation_bytes"] == 0
    assert rec["cost"]["loops"] == []
    # leaf by leaf: the port's placed blocks against the reference's
    cfg = configs.reduced("qwen3-8b")
    cell = dataclasses.replace(configs.SHAPES[shape], global_batch=8,
                               seq_len=64)
    lowered = dryrun.lower_cell(cfg, cell, dryrun.make_mesh(False, (2, 2),
                                                            "cpu"),
                                device="cpu")
    names = {"decode_32k": ("params", "cache", "token", "pos"),
             "prefill_32k": ("params", "tokens"),
             "train_4k": ("state",)}[shape]
    got: dict = {}
    for name, arg in zip(names, lowered.args):
        _leaf_bytes(name, arg, got)
    assert got == {k: v for k, v in want["leaf_bytes"].items()
                   if k.split("/")[0] in names}


@pytest.mark.parametrize("arch", sorted(configs.CLI_IDS))
def test_count_params_and_model_flops_equal_the_references(reference, arch):
    ref = reference()
    cfg = configs.get(arch)
    assert list(dryrun.count_params(cfg)) == ref["params"][arch]
    assert {c.name: dryrun.model_flops(cfg, c)
            for c in applicable_shapes(cfg)} == ref["model_flops"][arch]


def test_decode_collectives_stay_within_the_budget(cells):
    recs, _ = cells
    budget = _decode_comm_budget(api.build_model(
        configs.reduced("qwen3-8b"), tp=2, max_seq=64))
    counts = recs["decode_32k"]["collectives"]["count_by_op"]
    assert counts and all(v <= budget[k] for k, v in counts.items())
    coll = recs["decode_32k"]["collectives"]
    assert coll["total_bytes"] == sum(coll["bytes_by_op"].values()) > 0


def _decode_args(model, bits: int):
    params = model.init(0, device="cpu")
    params = quantize_for_serving(params, bits) if bits else params
    return (params, model.init_cache(4, device="cpu"),
            torch.zeros(4, dtype=torch.int32),
            torch.full((4,), 5, dtype=torch.int32))


@pytest.mark.parametrize("bits", [0, 8])
def test_a_fake_step_counts_as_the_real_call(monkeypatch, bits):
    """On the reduced qwen3-8b decode step at world 1 (dense, or 8-bit
    packed): `count_step` on fake tensors gives the flops, bytes, kernel
    launches and peak memory of the recorder's real call. The real call
    takes the card's route, the kernel's work done out of the recorder's
    sight as a `ctypes` launch is."""
    model = api.build_model(configs.reduced("qwen3-8b"), tp=1, max_seq=32)

    def as_card(x, packed, scale, *, bits):
        y = torch.empty((x.shape[0], packed.shape[1]), dtype=torch.float32)
        with _disable_current_modes():
            y.copy_(QM.quant_matmul_plain(x, packed, scale, bits=bits))
        return y

    route = ops._route
    with monkeypatch.context() as mp:
        mp.setattr(ops, "_route", lambda x, name: (
            "cuda" if route(x, name) == "plain" else route(x, name)))
        mp.setattr(QM, "quant_matmul_cuda", as_card)
        real = op_count.count_step(model.decode_step,
                                   *_decode_args(model, bits))
    with FakeTensorMode():
        fake = op_count.count_step(model.decode_step,
                                   *_decode_args(model, bits))
    for key in ("flops", "bytes_accessed", "kernel_launches", "peak_bytes"):
        assert getattr(fake, key) == getattr(real, key), key
    launches = {QM.NAME: 7 * model.cfg.n_layers} if bits else {}
    assert fake.kernel_launches == launches
    assert fake.flops > 0 and fake.loops == []


def _wrapper_cases():
    """(name, call, the real launch's flops and bytes, output shape) of
    each kernel wrapper at a small geometry."""
    m, k, n, kk = 6, 64, 32, 32
    x = torch.zeros((2, 3, k))
    values = torch.zeros((kk, n), dtype=torch.int8)
    select = torch.zeros((kk, n), dtype=torch.uint8)
    packed = torch.zeros((k, n), dtype=torch.uint8)
    xc = torch.zeros((2, 10, 8))
    return [
        (NM.NAME, lambda: ops.nm_spmm(x, values, select, group_size=16,
                                      keep=8),
         2 * m * kk * n, m * k * 4 + kk * n * 2 + n * 4 + m * n * 4,
         (2, 3, n)),
        (QM.NAME, lambda: ops.quant_matmul(x, packed, bits=8),
         2 * m * k * n, m * k * 4 + k * n + n * 4 + m * n * 4, (2, 3, n)),
        (BS.NAME, lambda: ops.bitserial_matmul(x, packed, bits=8),
         2 * m * k * n, m * k * 4 + k * n + n * 4 + m * n * 4, (2, 3, n)),
        # a 3 x 8 window: 24 rows of the 32 dense ones, 2 groups of 8 kept
        (SC.NAME, lambda: ops.sparse_conv1d(xc, values, select, ksize=3,
                                            group_size=16, keep=8),
         2 * 2 * 10 * 16 * n, xc.numel() * 4 + kk * n * 2 + n * 4
         + 2 * 10 * n * 4, (2, 10, n)),
    ]


@pytest.mark.parametrize("case", range(4))
def test_kernel_wrappers_on_fake_tensors(monkeypatch, case):
    """A fake tensor takes the card's route without the launch: the
    output's shape, float32 and the tensor's device; the launch's cost as
    the real one reports it; no plain version, no CUDA function, no
    kernel library, no launch counted."""

    def refuse(*a, **k):
        raise AssertionError("ran on a fake tensor")

    for mod in (NM, QM, BS, SC):
        for fn in dir(mod):
            if fn.endswith(("_plain", "_cuda")) or fn == "_library":
                monkeypatch.setattr(mod, fn, refuse)
    before = {mod: mod.launches for mod in (NM, QM, BS, SC)}
    with FakeTensorMode():
        name, call, flops, nbytes, shape = _wrapper_cases()[case]
        rec = torchprobe.CallRecord()
        torchprobe._COSTS.active.append(rec)
        try:
            y = call()
        finally:
            torchprobe._COSTS.active.pop()
    assert (tuple(y.shape), y.dtype, y.device.type) == (
        shape, torch.float32, "cpu")
    assert rec.kernel_launches == {name: 1}
    assert (rec.flops, rec.bytes_accessed) == (flops, nbytes)
    assert {mod: mod.launches for mod in (NM, QM, BS, SC)} == before


@pytest.mark.parametrize("case", range(4))
def test_a_wrapper_call_counts_its_formula_and_operand_casts(case):
    """One wrapper call on fake tensors under `count_step`: its bytes are
    the kernel's formula (`add_kernel_cost`, the output written once)
    plus what the operands' preparation moves, here the default scale's
    (1, N) float32 ones; the output's allocation (`torch.empty`) moves
    nothing. A bfloat16 `quant_matmul` input adds its float32 cast (read
    2 bytes, write 4 an element)."""
    with FakeTensorMode():
        name, call, flops, nbytes, shape = _wrapper_cases()[case]
        cost = op_count.count_step(call)
    n = shape[-1]
    assert cost.flops == flops and cost.kernel_launches == {name: 1}
    assert cost.bytes_accessed == nbytes + n * 4
    assert {t[2]: t[0] for t in cost.top_bytes} == {
        name: nbytes, "aten.ones": n * 4}
    if name == QM.NAME:
        with FakeTensorMode():
            x = torch.zeros((6, 64), dtype=torch.bfloat16)
            packed = torch.zeros((64, n), dtype=torch.uint8)
            cost = op_count.count_step(
                lambda: ops.quant_matmul(x, packed, bits=8))
        assert cost.bytes_accessed == nbytes + n * 4 + 6 * 64 * (2 + 4)


def test_a_real_cpu_tensor_takes_the_plain_version(monkeypatch):
    """Outside fake mode a CPU tensor runs the plain version and reports
    no launch, as before."""
    calls = []
    plain = QM.quant_matmul_plain
    monkeypatch.setattr(QM, "quant_matmul_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    rec = torchprobe.CallRecord()
    torchprobe._COSTS.active.append(rec)
    try:
        ops.quant_matmul(torch.ones((2, 8)), torch.zeros((8, 4),
                                                         dtype=torch.uint8),
                         bits=8)
    finally:
        torchprobe._COSTS.active.pop()
    assert calls == [1] and rec.kernel_launches == {}


def test_memtracker_peak_of_a_fake_two_matmul_step():
    """`count_step`'s peak (torch-internal `MemTracker`) on fake tensors:
    the arguments, then d = a @ b and e = d @ c live together."""
    with FakeTensorMode():
        a, b, c = (torch.empty(256, 512), torch.empty(512, 1024),
                   torch.empty(1024, 128))
        cost = op_count.count_step(lambda a, b, c: (a @ b) @ c, a, b, c)
    args = (256 * 512 + 512 * 1024 + 1024 * 128) * 4
    assert cost.peak_bytes == args + (256 * 1024 + 256 * 128) * 4
    assert cost.flops == 2 * 256 * 512 * 1024 + 2 * 256 * 1024 * 128


def test_hillclimb_w8_writes_its_record(cells, capsys):
    """`hillclimb --variant w8` on the reduced decode cell writes the
    `_w8` record beside the baseline and prints each term's change. Every
    packed projection runs the `quant_matmul` wrapper once, and the
    kernel's bytes are below the bf16 matmuls' it replaces. At this width
    (d_model 64) the step's memory term still rises, and not through
    allocations (they move no bytes): the packed params keep the
    embedding and head in float32 where the baseline casts them to bf16,
    so more bytes are placed and all-gathered, and the activations make a
    float32 round trip around the kernel; together they outweigh the
    projections' weight bytes saved. At qwen3-8b's full width the term
    falls (the card's `dryrun` phase checks it)."""
    recs, out = cells
    got = hillclimb.main(CELL_ARGS + ["--shape", "decode_32k", "--out",
                                      str(out), "--variant", "w8"])
    rec, base = got["record"], got["baseline"]
    assert (out / rec["mesh_name"] / "qwen3-reduced__decode_32k_w8.json"
            ).exists()
    assert base == recs["decode_32k"]
    assert set(got["delta_pct"]) == set(hillclimb.TERMS)
    assert "t_memory_s" in capsys.readouterr().out
    assert rec["cost"]["kernel_launches"] == {QM.NAME: 7 * 2}
    kernel = dict((t[2], t[0]) for t in rec["cost"]["top_bytes"])
    dense = dict((t[2], t[0]) for t in base["cost"]["top_bytes"])
    assert kernel[QM.NAME] < dense["aten.mm"]
    params = [r["memory"]["argument_bytes_by_kind"]["params"]
              for r in (base, rec)]
    assert params[1] > params[0]
    assert rec["roofline"]["t_memory_s"] > base["roofline"]["t_memory_s"]


def test_a_batch_the_pod_mesh_does_not_divide_runs_replicated(cells):
    """whisper's pure data parallelism puts its rows over every axis: the
    reference's `train_4k` (256 rows) on 2x16x16 (512 ranks) leaves the
    batch unsharded and GSPMD computes it on every device. The port's
    step runs the whole batch on each rank alike (here 4 rows over a fake
    2x2x2), and counts the replicated inputs. Only the dry-run asks for
    that: the trainer's own step refuses such a batch."""
    rec = dryrun.main(["--arch", "whisper-tiny", "--reduced", "--shape",
                       "train_4k", "--batch", "4", "--seq", "64",
                       "--mesh-shape", "2x2x2", "--out", str(cells[1]),
                       "--device", "cpu"])[0]
    cfg = configs.reduced("whisper-tiny")
    # int32 tokens and targets, bfloat16 frames: every row on every rank
    batch = 4 * 64 * 4 * 2 + 4 * cfg.enc_seq * cfg.d_model * 2
    assert rec["mesh_name"] == "multipod_2x2x2"
    assert rec["memory"]["argument_bytes_by_kind"]["inputs"] == batch
    assert rec["cost"]["per_device_flops"] > 0


def test_the_trainer_refuses_a_batch_its_ranks_do_not_divide(cells):
    """`trainer._rows` raises on 4 rows over whisper's 8 row-carrying
    ranks of a 2x2x2 mesh, as before the dry-run; with
    `replicate_indivisible` (which only the dry-run passes) every rank
    runs the whole batch, and a batch that divides is split as ever."""
    from repro_torch.train import trainer

    cfg = configs.reduced("whisper-tiny")
    mesh = dryrun.make_mesh(True, (2, 2, 2), "cpu")
    batch = {"tokens": torch.arange(4 * 3).reshape(4, 3)}
    with pytest.raises(ValueError, match="not divisible"):
        trainer._rows(batch, cfg, mesh)
    whole = trainer._rows(batch, cfg, mesh, replicate_indivisible=True)
    assert whole["tokens"] is batch["tokens"]
    rows = trainer._rows({"tokens": torch.arange(8 * 3).reshape(8, 3)},
                         cfg, mesh)
    assert rows["tokens"].tolist() == [[0, 1, 2]]

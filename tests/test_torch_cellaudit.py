"""The cell auditor's counterpart (`repro_torch.analysis`) against the
reference's (`repro.analysis.cellaudit`), on the CPU.

The reference re-lowers each registered jit cell from the avals its
first call captured and scans the optimized HLO; the port records the
first real call of each eager cell (`obs.torchprobe.record_call`) and
checks the record (`analysis.opscan`). These hold:

- the pure checks (`opscan`) on hand-made records, and the budget rule
  equal to the reference's `hloscan.over_budget` on the same inventories;
- the reference's auditor cases (`tests/test_analysis.py`), each on a
  torch cell: a clean cell, a never-called cell, a host read (`.item()`
  in place of `jax.debug.callback`), float64, a budget blown by counted
  collectives (a world-1 gloo group) and an unbudgeted cell that records
  without gating, a dropped donation, the section's keys equal to the
  reference's, a tracked cell that records its first call and delegates;
- the reduced qwen3 engine, dense and paged with chunked prefill, the
  same requests through the reference's engine and the port's: the same
  cell names after the same run, 0 violations in both; the sharded
  engine on a 1-device mesh: the same cells and the same violations as
  the reference's auditor reports there (every declared-sharded cell's
  outputs are replicated on one device);
- `cost_gauges`: the flops of a recorded call (the dispatcher's count
  plus what a kernel wrapper reports for its own launch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import CPU, shared_lm_models

from repro import obs as jobs
from repro.analysis import cellaudit as jcellaudit
from repro.analysis import hloscan
from repro.launch.mesh import make_serving_mesh as jmesh
from repro.serve import engine as jE
from repro.serve import paging as jpaging
from repro.serve import sharded as jSH
from repro_torch import obs
from repro_torch.analysis import cellaudit, opscan
from repro_torch.dist import sharding as shd
from repro_torch.launch import _spawn
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.obs import registry, torchprobe
from repro_torch.serve import engine as tE
from repro_torch.serve import paging as tpaging
from repro_torch.serve import sharded as tSH


def _cell(fn, **meta):
    return torchprobe.CellInfo(name="t.cell", fn=fn, **meta)


def _called(info, *args):
    torchprobe.record_call(info, *args)
    return info


# ---------------------------------------------------------------------------
# opscan: pure checks over a record
# ---------------------------------------------------------------------------


def test_opscan_f64_and_host_ops():
    rec = torchprobe.CallRecord(
        f64=["aten.add"],
        host_reads=["aten._local_scalar_dense (a host read of a value)"],
        transfers=["aten._to_copy (cuda:0 -> cpu)"],
    )
    assert opscan.f64_ops(rec) == ["aten.add"]
    ops = opscan.host_transfer_ops(rec)
    assert len(ops) == 2 and any("_local_scalar_dense" in o for o in ops)
    kept = {"before": [1, 2], "after": [1, 2], "in_outputs": True}
    rec.donated = {0: kept}
    assert opscan.donation_aliased(rec, (0,))
    rec.donated = {0: {**kept, "in_outputs": False}}
    assert not opscan.donation_aliased(rec, (0,))
    rec.donated = {0: {**kept, "after": [1, 3]}}
    assert not opscan.donation_aliased(rec, (0,))
    assert not opscan.donation_aliased(torchprobe.CallRecord(), (0,))


@pytest.mark.parametrize("budget", [
    {"all-reduce": 5, "all-gather": 2},
    {"all-reduce": 4},
    {"all-reduce": "*", "all-gather": -1},
    {},
])
def test_opscan_budget_is_the_references(budget):
    counts = {"all-reduce": 5, "all-gather": 2}
    assert opscan.over_budget(counts, budget) == hloscan.over_budget(
        counts, budget)


def test_opscan_sharded_outputs_from_specs():
    rec = torchprobe.CallRecord(outputs=[torch.Size((2, 8)), {
        "k": torch.Size((2, 4, 3)), "pos": torch.Size((2,))}])
    specs = [(("data",), None), {"k": (("data",), None, "model")}]
    pairs = opscan.global_shapes(rec, specs, {"data": 2, "model": 3})
    assert pairs == [((2, 8), (4, 8)), ((2, 4, 3), (4, 4, 9)),
                     ((2,), (2,))]
    assert opscan.outputs_sharded(rec, specs, {"data": 2, "model": 3})
    assert not opscan.outputs_sharded(rec, specs, {"data": 1, "model": 1})


# ---------------------------------------------------------------------------
# the auditor on tiny cells (tests/test_analysis.py's cases)
# ---------------------------------------------------------------------------


def test_audit_clean_cell():
    audit = cellaudit.audit_cell(_called(_cell(lambda x: x * 2),
                                         torch.ones(4)))
    assert audit.violations == [], audit.violations


def test_audit_never_called_cell():
    audit = cellaudit.audit_cell(_cell(lambda x: x))
    assert len(audit.violations) == 1
    assert "never called" in audit.violations[0]


def test_audit_flags_host_read():
    def f(x):
        if x.sum().item() > 0:  # the host reads a value
            return x + 1
        return x

    audit = cellaudit.audit_cell(_called(_cell(f), torch.ones(2)))
    assert any("_local_scalar_dense" in v for v in audit.violations), (
        audit.violations)


@pytest.mark.parametrize("fn,op", [
    (lambda x: x[x > 0], "aten.index"),
    (lambda x: torch.nonzero(x), "aten.nonzero"),
    (lambda x: x + torch.tensor([1.0, 2.0]), "aten.lift_fresh"),
    (lambda x: bool(torch.equal(x, x)) and x, "aten.equal"),
])
def test_audit_flags_what_waits_for_the_host(fn, op):
    """A boolean mask, a data-dependent shape, host data made a tensor,
    and `torch.equal`: each waits for (or copies from) the host on the
    card."""
    audit = cellaudit.audit_cell(_called(_cell(fn), torch.ones(2)))
    assert any(op in v for v in audit.violations), audit.violations


def test_audit_flags_float64():
    audit = cellaudit.audit_cell(_called(
        _cell(lambda x: x.double().sum().float()), torch.ones(3)))
    assert any("f64" in v for v in audit.violations), audit.violations


def test_audit_flags_budget_blowup():
    """Collectives handed to a world-1 gloo group, counted by kind
    (`dist.sharding.comm_calls`): within budget, past it, unbudgeted."""
    def f(x):
        for _ in range(3):
            x = shd.all_reduce(x, None)
        return shd.all_gather(x, None, 0)

    with _spawn.process_group("cpu", timeout_s=60):
        info = _called(_cell(f, budget={"all-reduce": 3, "all-gather": 1}),
                       torch.ones(2))
        assert cellaudit.audit_cell(info).violations == []
        info = _called(_cell(f, budget={"all-reduce": 0}), torch.ones(2))
        audit = cellaudit.audit_cell(info)
        assert len(audit.violations) == 2, audit.violations
        assert all("collective budget exceeded" in v
                   for v in audit.violations)
        assert audit.collectives == {"all-reduce": 3, "all-gather": 1}
        # unbudgeted cells record the inventory but never gate on it
        info.budget = None
        audit = cellaudit.audit_cell(info)
        assert audit.violations == []
        assert audit.collectives == {"all-reduce": 3, "all-gather": 1}


def test_audit_flags_dropped_donation():
    """A cell declaring donate=(0,) that returns a new tensor dropped the
    donation; one that writes into its argument kept it."""
    dropped = _called(_cell(lambda x: x.to(torch.float32), donate=(0,)),
                      torch.ones(8, dtype=torch.int8))
    audit = cellaudit.audit_cell(dropped)
    assert any("donat" in v.lower() for v in audit.violations), (
        audit.violations)
    assert audit.donation_aliased is False
    kept = _called(_cell(lambda p: {"a": p["a"].add_(1)}, donate=(0,)),
                   {"a": torch.ones(4)})
    audit = cellaudit.audit_cell(kept)
    assert audit.violations == [] and audit.donation_aliased is True


def test_audit_section_keys_are_the_references():
    info = _called(_cell(lambda x: x * 2), torch.ones(4))
    sec = cellaudit.audit_section({"t.cell": info})
    jinfo = jobs.jaxprobe.CellInfo(name="t.cell", fn=jax.jit(lambda x: x * 2))
    jinfo.call_avals = ((jax.ShapeDtypeStruct((4,), jnp.float32),), {})
    want = jcellaudit.audit_section({"t.cell": jinfo})
    assert sec == want
    assert set(sec["cells"]["t.cell"]) == {
        "violations", "collectives", "donation_aliased",
    }


def test_tracked_cell_records_its_first_call_and_delegates():
    tel = obs.configure(enabled=True)
    try:
        calls = []

        def f(x):
            calls.append(1)
            return x + 1

        cell = tel.probe.track("t.capture", f)
        out = cell(torch.ones(3))
        assert float(out.sum()) == 6.0
        info = tel.probe.cells()["t.capture"].info
        rec = info.call_record
        assert rec.outputs == torch.Size((3,)) and rec.ops >= 1
        assert float(cell(torch.ones(3)).sum()) == 6.0
        assert info.call_record is rec  # recorded once, never per call
        assert len(calls) == 2  # the first call ran once, recorded
        assert tel.probe.cache_sizes() == {"t.capture": 1}
        assert cellaudit.audit_cell(info).violations == []
        assert cellaudit.audit_cells() == {
            "t.capture": cellaudit.audit_cell(info)}
    finally:
        obs.reset()


def test_disabled_probe_records_nothing():
    f = lambda x: x  # noqa: E731
    assert torchprobe.TorchProbe(enabled=False).track("a", f, donate=(0,)) is f
    assert obs.get().probe.track("a", f, budget={}) is f


# ---------------------------------------------------------------------------
# the serve cells of the reduced qwen3 engine against the reference's
# ---------------------------------------------------------------------------

PROMPTS = (3, 9, 5, 3, 6)
POOL = 4


def _drive(make_engine, E, tokens):
    reqs = [E.Request(uid=i, prompt=tokens(i, n), max_new=4)
            for i, n in enumerate(PROMPTS)]
    eng = make_engine()
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(map(int, r.output)) for r in reqs]


def _ref_audit(make_engine):
    jobs.configure(enabled=True)
    try:
        toks = _drive(make_engine, jE,
                      lambda i, n: (jnp.arange(n, dtype=jnp.int32) + i) % 7)
        return toks, jcellaudit.audit_section()
    finally:
        jobs.reset()


def _port_audit(make_engine):
    obs.configure(enabled=True)
    try:
        toks = _drive(make_engine, tE,
                      lambda i, n: (torch.arange(n) + i) % 7)
        return toks, cellaudit.audit_section()
    finally:
        obs.reset()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_cells_audit_as_the_references(paged):
    """The reduced qwen3 engine (paged: the page pool and chunked
    prefill) on the same requests: the same tokens, the same cell names
    registered (at first use, as the reference's), every cell audited
    clean on both sides."""
    mj, mt, pj, pt = shared_lm_models("qwen3_8b")
    kw_j = kw_t = {}
    if paged:
        kw_j = dict(paging=jpaging.PagingConfig(4, 20), chunk_tokens=4)
        kw_t = dict(paging=tpaging.PagingConfig(4, 20), chunk_tokens=4)
    toks_j, want = _ref_audit(
        lambda: jE.Engine(mj, pj, batch_size=POOL, **kw_j))
    toks_t, got = _port_audit(
        lambda: tE.Engine(mt, pt, batch_size=POOL, device=CPU, **kw_t))
    assert toks_t == toks_j
    assert sorted(got["cells"]) == sorted(want["cells"])
    assert got["violations_total"] == want["violations_total"] == 0, got
    seat = got["cells"]["serve.seat"]
    assert seat["donation_aliased"] is want["cells"]["serve.seat"][
        "donation_aliased"] is True


def test_sharded_engine_on_one_device_audits_as_the_references():
    """`ShardedEngine` on a 1-device mesh (a world-1 gloo group): the
    reference's cell names, collectives (none) and violations — every
    cell declaring sharded outputs is fully replicated on one device, as
    the reference's auditor reports it."""
    mj, mt, pj, pt = shared_lm_models("qwen3_8b")
    toks_j, want = _ref_audit(lambda: jSH.ShardedEngine(
        mj, pj, batch_size=POOL, mesh=jmesh("1")))
    with _spawn.process_group("cpu", timeout_s=60):
        toks_t, got = _port_audit(lambda: tSH.ShardedEngine(
            mt, pt, batch_size=POOL, mesh=make_serving_mesh("1", "cpu"),
            device=CPU))
    assert toks_t == toks_j
    assert got["violations_total"] == want["violations_total"] == len(
        got["cells"]) > 0
    assert sorted(got["cells"]) == sorted(want["cells"])
    for name, cell in got["cells"].items():
        ref = want["cells"][name]
        assert cell["collectives"] == ref["collectives"] == {}
        assert cell["donation_aliased"] is ref["donation_aliased"]
        assert len(cell["violations"]) == len(ref["violations"]) == 1
        for v in (cell["violations"][0], ref["violations"][0]):
            assert v.startswith("declared sharded_outputs but every")
            assert v.endswith("output is fully replicated")


# ---------------------------------------------------------------------------
# cost gauges
# ---------------------------------------------------------------------------


def test_cost_gauges_count_the_call_and_the_kernels_it_reports():
    """flops of a recorded call: the dispatcher's matmul (2·M·K·N) plus
    what a kernel's wrapper reports for its own launch (the dispatcher
    does not see a kernel called through ctypes); bytes of each op's
    tensors."""
    m, k, n = 4, 16, 8
    x, w = torch.ones((m, k)), torch.ones((k, n))

    def f(x):
        torchprobe.add_kernel_cost("quant_matmul", 2 * m * k * n, 1000)
        return x @ w

    info = _called(_cell(f), x)
    rec = info.call_record
    assert rec.kernel_launches == {"quant_matmul": 1}
    assert rec.flops == 2 * (2 * m * k * n)
    assert rec.bytes_accessed == 1000 + 4 * (m * k + k * n + m * n)
    reg = registry.Registry()
    got = torchprobe.cost_gauges(reg, "t.cell", info)
    assert got == {"flops": rec.flops, "bytes accessed": rec.bytes_accessed}
    gauges = reg.snapshot()["gauges"]
    assert gauges["t.cell.flops"]["value"] == rec.flops
    assert gauges["t.cell.bytes_accessed"]["value"] == rec.bytes_accessed
    torchprobe.add_kernel_cost("quant_matmul", 1, 1)  # no record open
    assert rec.kernel_launches == {"quant_matmul": 1}
    assert torchprobe.cost_gauges(reg, "t.none", _cell(f)) == {}


def test_cost_gauges_of_a_packed_projection_on_the_cpu():
    """One 8-bit packed projection through `linear_apply` (its plain
    version here): the dispatcher counts the dequantized matmul's
    2·M·K·N."""
    from repro_torch.models import layers

    m, k, n = 3, 32, 16
    gen = torch.Generator().manual_seed(0)
    lin = layers.compile_linear_quant(
        {"w": torch.randn((k, n), generator=gen)}, 8)
    info = _called(_cell(lambda x: layers.linear_apply(lin, x)),
                   torch.randn((m, k), generator=gen))
    got = torchprobe.cost_gauges(registry.Registry(), "proj", info)
    assert got["flops"] == 2 * m * k * n
    assert dataclasses.asdict(info.call_record)["kernel_launches"] == {}


# ---------------------------------------------------------------------------
# the faults the audit found in the port's cells (ROADMAP.md §3), pinned
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gemma2_9b", "recurrentgemma_2b",
                                  "olmoe_1b_7b", "rwkv6_3b"])
def test_every_familys_serve_cells_audit_clean(name):
    """Each family's serve cells on the reduced config: none reads a value
    on the host or makes a tensor of host data (the repaired embedding
    scale and gelu constants, MoE's one-hot, attention's 1/sqrt(hd))."""
    from repro_torch import configs
    from repro_torch.models import api

    model = api.build_model(configs.reduced(name), tp=1, max_seq=24)
    params = model.init(0, device=CPU)
    obs.configure(enabled=True)
    try:
        _drive(lambda: tE.Engine(model, params, batch_size=2, device=CPU),
               tE, lambda i, n: (torch.arange(n) + i) % 7)
        sec = cellaudit.audit_section()
    finally:
        obs.reset()
    assert sec["violations_total"] == 0, sec
    assert {"serve.decode_step", "serve.prefill", "serve.seat"} <= set(
        sec["cells"])


def test_donated_train_step_audits_clean():
    """`launch.train`'s donated step at a constant learning rate: the
    results written into the state's storages, nothing read on the host,
    no host data made a tensor (the repaired constant schedule)."""
    from repro_torch import configs, optim
    from repro_torch.data import lm
    from repro_torch.models import api
    from repro_torch.train import trainer

    cfg = configs.reduced("qwen3_8b")
    model = api.build_model(cfg, tp=1, max_seq=16)
    opt = optim.adamw(3e-3)
    state = trainer.init_state(model.init(0, device=CPU), opt, device=CPU)
    info = _called(_cell(trainer.make_train_step(model.loss, opt,
                                                 donate=True), donate=(0,)),
                   state, lm.TokenStream(batch=2, seq_len=8, vocab=cfg.vocab,
                                         seed=0, device=CPU).batch_at(0))
    audit = cellaudit.audit_cell(info)
    assert audit.violations == [] and audit.donation_aliased is True

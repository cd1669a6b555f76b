"""The roofline report's port (`repro_torch.launch.{op_analysis,
roofline}`, `repro_torch.benchmarks.roofline_summary` and the fourth
section of `benchmarks.run`) against the reference's
`repro.launch.{hlo_analysis, roofline}`, on the CPU.

`roofline_terms` is the reference's formula with each side's constants:
the reference's TPU v5e (197e12 FLOP/s bf16, 819e9 B/s HBM, 50e9 B/s a
link), the port's H100 SXM data sheet (989e12 FLOP/s dense bf16, 3.35e12
B/s HBM, 450e9 B/s each way over NVLink). The renderers read the same
records and print the same text, but for the memory column's header,
which names the card.
"""

import copy
import json

import pytest

from repro.launch import hlo_analysis as JH
from repro.launch import roofline as JR
from repro_torch.benchmarks import roofline_summary
from repro_torch.benchmarks import run as brun
from repro_torch.launch import op_analysis as TH
from repro_torch.launch import roofline as TR

INPUTS = [
    dict(per_device_flops=3.1e12, per_device_bytes=2.2e10,
         per_device_collective_bytes=4.0e8, model_flops_total=6.0e14,
         n_devices=256, per_device_arg_bytes=1.2e9),
    dict(per_device_flops=1.0e9, per_device_bytes=5.0e11,
         per_device_collective_bytes=0.0, model_flops_total=2.0e11,
         n_devices=1, per_device_arg_bytes=3.0e11),
    dict(per_device_flops=0.0, per_device_bytes=0.0,
         per_device_collective_bytes=9.0e9, model_flops_total=0.0,
         n_devices=512),
]


def test_each_sides_constants():
    assert (JH.PEAK_FLOPS_BF16, JH.HBM_BW, JH.ICI_BW) == (197e12, 819e9,
                                                          50e9)
    assert (TH.PEAK_FLOPS_BF16, TH.HBM_BW, TH.NVLINK_BW) == (989e12, 3.35e12,
                                                             450e9)


@pytest.mark.parametrize("case", range(len(INPUTS)))
def test_roofline_terms_are_the_references_formula(monkeypatch, case):
    """With the reference's constants set to the H100's, its
    `roofline_terms` gives the port's dict key for key."""
    monkeypatch.setattr(JH, "PEAK_FLOPS_BF16", TH.PEAK_FLOPS_BF16)
    monkeypatch.setattr(JH, "HBM_BW", TH.HBM_BW)
    monkeypatch.setattr(JH, "ICI_BW", TH.NVLINK_BW)
    assert (TH.roofline_terms(**INPUTS[case])
            == JH.roofline_terms(**INPUTS[case]))


def test_collective_stats_from_counted_calls():
    stats = TH.collective_stats({"all-gather": 4, "all-reduce": 5},
                                {"all-gather": 73728, "all-reduce": 2560})
    assert stats.to_dict() == {
        "bytes_by_op": {"all-gather": 73728, "all-reduce": 2560},
        "count_by_op": {"all-gather": 4, "all-reduce": 5},
        "total_bytes": 76288}


def _record(arch, shape, kind, dominant, t, frac, useful, mem, emu=0):
    return {
        "arch": arch, "shape": shape, "kind": kind,
        "memory": {"total_per_device_bytes": mem,
                   "bf16_emulation_bytes": emu},
        "roofline": {"t_compute_s": t[0], "t_memory_s": t[1],
                     "t_collective_s": t[2], "dominant": dominant,
                     "bound_s": max(t), "useful_flops_ratio": useful,
                     "roofline_fraction": frac},
    }


RECORDS = [
    _record("qwen3-8b", "decode_32k", "decode", "memory",
            (2e-6, 8e-4, 3e-5), 0.102, 1.07, 6 * 2**29),
    _record("qwen3-8b", "train_4k", "train", "compute",
            (3.2, 0.9, 0.4), 0.81, 0.42, 70 * 2**30, emu=2**30),
    _record("olmoe-1b-7b", "prefill_32k", "prefill", "collective",
            (0.02, 0.05, 0.31), 0.06, 0.9, 3 * 2**30),
    _record("rwkv6-3b", "train_4k", "train", "memory",
            (0.5, 1.5, 0.1), 0.3, 0.7, 9 * 2**30),
    _record("whisper-tiny", "prefill_32k", "prefill", "compute",
            (1.5e-3, 1e-4, 0.0), 0.95, 0.97, 2**20),
]


def _write(root, mesh, records, tag=""):
    d = root / mesh
    d.mkdir(parents=True, exist_ok=True)
    for r in records:
        (d / f"{r['arch']}__{r['shape']}{tag}.json").write_text(
            json.dumps(r))


def test_renderers_print_the_references_text(tmp_path, capsys):
    """`load_records` (baselines only, variants with include_variants),
    `render_table`, `render_notes` and `main` equal the reference's on
    the same records, the header's card word aside."""
    mesh = "singlepod_16x16"
    _write(tmp_path, mesh, RECORDS)
    _write(tmp_path, mesh, RECORDS[:1], tag="_w8")
    for variants in (False, True):
        got = TR.load_records(str(tmp_path), mesh, include_variants=variants)
        assert got == JR.load_records(str(tmp_path), mesh,
                                      include_variants=variants)
        assert len(got) == len(RECORDS) + variants
    recs = TR.load_records(str(tmp_path), mesh)
    assert TR.render_table(recs) == JR.render_table(recs).replace(
        "(tpu-adj)", "(h100-adj)")
    assert TR.render_notes(recs) == JR.render_notes(recs)
    assert [TR.improvement_note(r) for r in recs] == [
        JR.improvement_note(r) for r in recs]
    TR.main(["--dir", str(tmp_path), "--mesh", mesh])
    printed = capsys.readouterr().out
    assert "worst roofline fraction : olmoe-1b-7b x prefill_32k (0.060)" \
        in printed
    TR.main(["--dir", str(tmp_path / "none"), "--mesh", mesh])
    assert "no records under" in capsys.readouterr().out


def test_roofline_summary_rows(monkeypatch, tmp_path):
    """`roofline.missing` with no records; one row a baseline record of
    every mesh directory with them, as the reference's rows read."""
    monkeypatch.setattr(roofline_summary, "DRYRUN_DIR", str(tmp_path / "none"))
    assert roofline_summary.run() == [
        ("roofline.missing", 0.0,
         "run `python -m repro_torch.launch.dryrun` first")]
    _write(tmp_path, "singlepod_16x16", RECORDS[:2])
    _write(tmp_path, "multipod_2x16x16", RECORDS[2:])
    _write(tmp_path, "multipod_2x16x16", RECORDS[2:3], tag="_w8")
    monkeypatch.setattr(roofline_summary, "DRYRUN_DIR", str(tmp_path))
    rows = roofline_summary.run()
    assert len(rows) == len(RECORDS)
    assert rows[0] == (
        "roofline.singlepod_16x16.qwen3-8b.decode_32k", 8e-4 * 1e6,
        "dom=memory frac=0.102 useful=1.070 mem_gib=3.00")


def test_benchmarks_run_prints_the_roofline_section(monkeypatch, tmp_path,
                                                    capsys):
    """`benchmarks.run.main`'s fourth section: `roofline.missing` without
    records, one row a record with them (the other sections stubbed)."""
    for mod in (brun.table1, brun.kernels, brun.ablation):
        monkeypatch.setattr(mod, "run", lambda *a, **k: [])
    monkeypatch.setattr(roofline_summary, "DRYRUN_DIR", str(tmp_path / "none"))
    brun.main(device="cpu")
    assert capsys.readouterr().out.splitlines() == [
        "name,us_per_call,derived",
        "roofline.missing,0.00,run `python -m repro_torch.launch.dryrun` "
        "first"]
    _write(tmp_path, "mesh_1x1", copy.deepcopy(RECORDS[:3]))
    monkeypatch.setattr(roofline_summary, "DRYRUN_DIR", str(tmp_path))
    brun.main(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and all(
        line.startswith("roofline.mesh_1x1.") for line in lines[1:])

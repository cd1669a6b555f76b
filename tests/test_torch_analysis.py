"""The AST rule pack's port (`repro_torch.analysis.{astpass, rules,
__main__}`) and the bench-schema guard's
(`repro_torch.benchmarks.check_schema`) against the reference's
`repro.analysis` and `scripts/check_bench_schema.py`, on the CPU.

The six rules that apply to any Python are the reference's: both
scanners must give equal (rule, path, line, message, snippet,
suppressed_by) lists on the reference's own goldens and suppression
cases (loaded from `tests/test_analysis.py` under another module name,
so the two suites cannot drift) and on the whole repo. The four torch
rules have goldens of their own, and the tracked-cell resolver's reading
of the port's `.track(...)` sites is pinned. The whole repo is parsed
once a module (`repo`): the reference's scan reads that parse through
its own `parse_file` name, so each scanner runs its own walk, rules and
suppression on the same trees.
"""

import copy
import importlib
import importlib.util
import json
from pathlib import Path

import pytest

from repro.analysis import astpass as ref_astpass
from repro.analysis.rules import RULES as REF_RULES
from repro_torch import analysis, obs
from repro_torch.analysis import astpass, rules
from repro_torch.analysis.rules import RULES
from repro_torch.benchmarks import check_schema

REPO = Path(__file__).resolve().parent.parent
SHARED = ("np-index-dtype", "driver-thread-affinity",
          "telemetry-eager-format", "mutable-default", "broad-except-pass",
          "wallclock-ban")
TORCH_RULES = ("global-rng", "host-sync-in-cell", "numpy-in-cell",
               "track-donate-pool")
REPO_DIRS = ("src", "scripts", "benchmarks", "examples")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_T = _load("_reference_test_analysis", REPO / "tests" / "test_analysis.py")
REF_SCHEMA = _load("_reference_check_bench_schema",
                   REPO / "scripts" / "check_bench_schema.py")
REF_CLI = importlib.import_module("repro.analysis.__main__")
PORT_CLI = importlib.import_module("repro_torch.analysis.__main__")


def _shared(pack):
    return tuple(r for r in pack if r.rule_id in SHARED)


def _rows(res) -> list:
    return [(f.rule, f.path, f.line, f.message, f.snippet, f.suppressed_by)
            for f in res.findings + res.suppressed]


def _scan_both(tmp_path, files: dict, baseline=None):
    """Both scanners over `files` ({relative path: source}) written under
    `tmp_path`, with the six shared rules."""
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    ref = ref_astpass.scan_paths([tmp_path], _shared(REF_RULES),
                                 baseline=baseline, root=tmp_path)
    port = astpass.scan_paths([tmp_path], _shared(RULES),
                              baseline=baseline, root=tmp_path)
    return ref, port


def _port_findings(tmp_path, files: dict, rule_id: str) -> list:
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    res = astpass.scan_paths([tmp_path], RULES, root=tmp_path)
    assert not res.stale_baseline
    return [f for f in res.findings if f.rule == rule_id]


# ---------------------------------------------------------------------------
# the shared rules: the reference's goldens and suppression cases
# ---------------------------------------------------------------------------


def test_rule_catalogs():
    assert set(SHARED) <= set(REF_T.GOLDENS)
    assert {r.rule_id for r in RULES} == set(SHARED) | set(TORCH_RULES)
    assert [type(r).__name__ for r in _shared(RULES)] == [
        type(r).__name__ for r in _shared(REF_RULES)]
    assert set(TORCH_GOLDENS) == set(TORCH_RULES)
    for r in RULES:
        assert r.summary and r.incident
    # each torch rule names the reference rule it stands for
    stands_for = {"global-rng": "prng-key-reuse",
                  "host-sync-in-cell": "traced-python-branch",
                  "numpy-in-cell": "numpy-in-jit",
                  "track-donate-pool": "jit-donate-pool"}
    for r in RULES:
        if r.rule_id in stands_for:
            assert stands_for[r.rule_id] in r.incident


@pytest.mark.parametrize("rule_id", SHARED)
def test_shared_goldens_equal(rule_id, tmp_path):
    bad, n_expected, good = REF_T.GOLDENS[rule_id]
    ref, port = _scan_both(tmp_path / "bad", {"snippet.py": bad})
    assert _rows(port) == _rows(ref)
    assert len([f for f in port.findings if f.rule == rule_id]) == n_expected
    ref, port = _scan_both(tmp_path / "good", {"snippet.py": good})
    assert _rows(port) == _rows(ref) == []


_WALL_CASES = {
    "pragma_on_line": (REF_T._WALL.replace(
        "return time.time()",
        "return time.time()  # repro: allow[wallclock-ban] metadata"), None),
    "pragma_line_above": (REF_T._WALL.replace(
        "    return time.time()",
        "    # repro: allow[wallclock-ban] metadata\n"
        "    return time.time()"), None),
    "pragma_wrong_rule": (REF_T._WALL.replace(
        "return time.time()",
        "return time.time()  # repro: allow[mutable-default] nope"), None),
    "baseline_match": (REF_T._WALL, [{
        "rule": "wallclock-ban", "path": "snippet.py",
        "snippet": "return time.time()"}]),
    "baseline_stale": (REF_T._WALL, [{
        "rule": "wallclock-ban", "path": "snippet.py",
        "snippet": "return time.time()  # long gone"}]),
}


@pytest.mark.parametrize("case", sorted(_WALL_CASES))
def test_suppression_equal(case, tmp_path):
    src, baseline = _WALL_CASES[case]
    ref, port = _scan_both(tmp_path, {"snippet.py": src}, baseline=baseline)
    assert _rows(port) == _rows(ref) and _rows(port)
    assert port.stale_baseline == ref.stale_baseline
    assert bool(port.stale_baseline) == (case == "baseline_stale")


# ---------------------------------------------------------------------------
# the whole repo, parsed once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def repo():
    """One parse of `src/ scripts/ benchmarks/ examples/` and
    `chip_smoke.py`; the reference's whole-repo scan and the port's, with
    the six shared rules and an empty baseline, on it."""
    paths = [REPO / d for d in REPO_DIRS if (REPO / d).exists()]
    infos = astpass.parse_paths(paths + [REPO / "chip_smoke.py"], root=REPO)
    by_path = {info.path.resolve(): info for info in infos}

    def shared_parse(path, root=None):
        info = by_path[Path(path).resolve()]
        return ref_astpass.FileInfo(path=info.path, rel=info.rel,
                                    tree=info.tree, lines=info.lines)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_astpass, "parse_file", shared_parse)
        ref = ref_astpass.scan_paths(paths, _shared(REF_RULES), baseline=[],
                                     root=REPO)
    whole = [i for i in infos if i.rel != "chip_smoke.py"]
    port = astpass.scan_files(whole, _shared(RULES), baseline=[])
    tree = [i for i in infos if i.rel == "chip_smoke.py"
            or i.rel.startswith("src/repro_torch/")]
    return {"ref": ref, "port": port, "tree": tree}


def test_whole_repo_equal(repo):
    ref, port = repo["ref"], repo["port"]
    assert port.files_scanned == ref.files_scanned > 200
    assert _rows(port) == _rows(ref)
    # the reference's two baselined telemetry gauges are live here
    jaxprobe = [f for f in port.findings
                if f.path == "src/repro/obs/jaxprobe.py"]
    assert [f.rule for f in jaxprobe] == ["telemetry-eager-format"] * 2


def test_port_tree_scans_clean(repo):
    baseline = astpass.load_baseline(
        REPO / "src" / "repro_torch" / "analysis" / "baseline.json")
    res = astpass.scan_files(repo["tree"], RULES, baseline=baseline)
    assert res.findings == [], [f.to_dict() for f in res.findings]
    assert res.stale_baseline == []
    assert res.files_scanned > 100
    # the one pragma the port carries, which the reference's scan honours
    assert [(f.rule, f.path, f.suppressed_by) for f in res.suppressed] == [
        ("wallclock-ban", "src/repro_torch/train/checkpoint.py", "pragma")]
    rep = res.to_report(analysis.SCHEMA_VERSION, RULES)
    assert check_schema.check_record("report", rep, obs.SCHEMA_VERSION) == []


def _site_rows(sites) -> list:
    out = []
    for s in sites:
        targets = None if s.targets is None else tuple(sorted(
            f"{Path(t.info.rel).name}:{rules._fn_label(t.node)}"
            for t in s.targets))
        out.append(repr((Path(s.info.rel).name, s.cell, targets)))
    return sorted(out)


def test_resolver_pins_port_track_sites(repo):
    ctx = astpass.Context(files=repo["tree"])
    got = _site_rows(rules.tracked_sites(ctx))
    seat = ("seating.py:scatter_pages", "seating.py:scatter_slots")
    chunk = ("engine.py:fn",)
    want = sorted(repr(r) for r in [
        ("engine.py", "serve.prefill", None),
        ("engine.py", "serve.seat", seat),
        ("engine.py", "serve.chunk", chunk),
        ("engine.py", "serve.decode_step", None),
        ("engine.py", "serve.decode_step", ("engine.py:<lambda>",)),
        ("sharded.py", "f'serve.prefill.w{rows}'", None),
        ("sharded.py", "f'serve.seat.w{rows}'", seat),
        ("sharded.py", "f'serve.chunk.c{c}'", chunk),
        ("trainer.py", "train.step", ("trainer.py:step",)),
        ("trainer.py", "train.multipod.step", ("trainer.py:step",)),
        ("train.py", "train.step", ("trainer.py:train_step",)),
        ("train.py", "train.step", ("trainer.py:train_step",)),
        ("runner.py", "f'stream.classify.{path}'", ("runner.py:_predict",)),
        ("fleet.py", "stream.vote", ("vote.py:update",)),
        ("dist_compression.py", "f'dist.reduce.{scheme}.n{n}'",
         ("dist_compression.py:<lambda>",) * 3),
        ("dist_compression.py", "f'train.dp_step.{mode}'",
         ("trainer.py:step",)),
    ])
    assert got == want


# ---------------------------------------------------------------------------
# the torch rules: bad/good goldens
# ---------------------------------------------------------------------------

TORCH_GOLDENS = {
    # (bad source, expected firing count), good twin
    "global-rng": (
        """\
import torch

def noise(x, n):
    a = torch.randn(n, x.shape[1])
    torch.manual_seed(0)
    b = torch.rand_like(x)
    x.normal_()
    g = torch.Generator().manual_seed(0)
    return a + b + torch.randint(0, 9, (n,), generator=g)
""",
        4,
        """\
import torch

def noise(x, n, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(n, x.shape[1], generator=g)
    b = torch.rand(x.shape, generator=g)
    x.normal_(generator=g)
    return a + b + torch.randperm(n, generator=g)
""",
    ),
    "host-sync-in-cell": (
        """\
import torch

class Runner:
    def __init__(self, probe):
        self._infer = probe.track("t.step", self._predict)
        self._count = probe.track("t.count", lambda x: int(x.sum().item()))

    def _predict(self, x):
        y = x * 2
        if (y > 0).any():
            y = y - 1
        print(y.tolist())
        return y.to("cpu"), y.cpu().numpy()
""",
        6,
        """\
import torch

class Runner:
    def __init__(self, probe):
        self._infer = probe.track("t.step", self._predict)

    def _predict(self, x):
        y = x * 2
        return torch.where(y > 0, y - 1, y)

    def report(self, y):
        if (y > 0).any():
            return y.tolist(), y.cpu().item()
        return None
""",
    ),
    "numpy-in-cell": (
        """\
import numpy as np
import torch

def make_cell():
    def cell(x):
        return torch.as_tensor(np.argmax(x, -1))
    return cell

def build(probe):
    return probe.track("t.cell", make_cell())
""",
        1,
        """\
import numpy as np
import torch

def make_cell(table):
    rows = np.asarray(table, np.int64)

    def cell(x):
        return torch.argmax(x, -1) + torch.as_tensor(rows)
    return cell

def build(probe):
    return probe.track("t.cell", make_cell([1, 2]))
""",
    ),
    "track-donate-pool": (
        """\
import functools

def scatter_slots(pool, rows, src, dst):
    pool[dst] = rows[src]
    return pool

def seat_pages(pool, rows, src, dst, phys, *, layouts):
    return pool

class Engine:
    def _seat_fn(self):
        if self.paged:
            return functools.partial(seat_pages, layouts=None)
        return scatter_slots

    def cells(self, probe):
        a = probe.track("serve.seat", self._seat_fn())
        b = probe.track("serve.pages", seat_pages, donate=())
        c = probe.track("serve.slots", scatter_slots)
        return a, b, c
""",
        2,
        """\
import functools

def scatter_slots(pool, rows, src, dst):
    pool[dst] = rows[src]
    return pool

def seat_pages(pool, rows, src, dst, phys, *, layouts):
    return pool

class Engine:
    def _seat_fn(self):
        if self.paged:
            return functools.partial(seat_pages, layouts=None)
        return scatter_slots

    def cells(self, probe):
        a = probe.track("serve.seat", self._seat_fn(), donate=(0,))
        c = probe.track("serve.slots", scatter_slots, donate=(0,))
        return a, c, probe.track("serve.prefill", self.model.prefill)
""",
    ),
}


@pytest.mark.parametrize("rule_id", TORCH_RULES)
def test_torch_golden_bad_fires(rule_id, tmp_path):
    bad, n_expected, _good = TORCH_GOLDENS[rule_id]
    hits = _port_findings(tmp_path, {"snippet.py": bad}, rule_id)
    assert len(hits) == n_expected, [f.to_dict() for f in hits]
    for f in hits:
        assert f.path == "snippet.py"
        assert f.line >= 1 and f.message and f.snippet


@pytest.mark.parametrize("rule_id", TORCH_RULES)
def test_torch_golden_good_twin_clean(rule_id, tmp_path):
    _bad, _n, good = TORCH_GOLDENS[rule_id]
    (tmp_path / "snippet.py").write_text(good)
    res = astpass.scan_paths([tmp_path], RULES, root=tmp_path)
    assert res.findings == [], [f.to_dict() for f in res.findings]


def test_torch_rule_pragma_silences(tmp_path):
    src = TORCH_GOLDENS["global-rng"][0].replace(
        "    torch.manual_seed(0)\n",
        "    # repro: allow[global-rng] the test seeds the process\n"
        "    torch.manual_seed(0)\n")
    assert len(_port_findings(tmp_path, {"snippet.py": src},
                              "global-rng")) == 3


# the resolver across files: a module alias, a name imported from a
# module, a base class's factory method in another module, the
# `self._cell(...)` wrapper, and the sites it must skip
_PKG = {
    "pkg/__init__.py": "",
    "pkg/vote.py": """\
def update(state, preds):
    n = int(preds.sum().item())
    return state, n
""",
    "pkg/engine.py": """\
from pkg import seating

def _chunk_fn(model):
    def fn(params, cache, toks):
        return model.step(params, cache, toks.tolist())
    return fn

class Engine:
    def _cell(self, fn):
        return fn

    def _seat_fn(self):
        return seating.scatter_slots
""",
    "pkg/seating.py": """\
def scatter_slots(pool, rows, src, dst):
    return pool
""",
    "pkg/sharded.py": """\
from pkg.engine import Engine, _chunk_fn

class ShardedEngine(Engine):
    def cells(self, probe):
        return (probe.track("serve.seat", self._seat_fn()),
                probe.track("serve.chunk", self._cell(_chunk_fn(self.model))),
                probe.track("serve.prefill", self._cell(self.model.prefill)))
""",
    "pkg/fleet.py": """\
from pkg import vote as V

def fn(pool, x):
    return pool

def run(probe, fn):
    vote = probe.track("stream.vote", V.update)
    return vote, probe.track("t.param", fn)
""",
}


def test_resolver_across_modules(tmp_path):
    for rel, src in _PKG.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    res = astpass.scan_paths([tmp_path], RULES, root=tmp_path)
    got = sorted((f.rule, f.path, f.line) for f in res.findings)
    assert got == [
        ("host-sync-in-cell", "pkg/engine.py", 5),
        ("host-sync-in-cell", "pkg/vote.py", 2),
        ("track-donate-pool", "pkg/sharded.py", 5),
    ], [f.to_dict() for f in res.findings]
    ctx = astpass.Context(files=astpass.parse_paths([tmp_path], tmp_path))
    resolved = {s.cell: s.targets is not None
                for s in rules.tracked_sites(ctx)}
    # `self.model.prefill` has no known type; `fn` is a parameter of
    # `run`, not the module's `fn`: both skipped, not guessed
    assert resolved == {"serve.seat": True, "serve.chunk": True,
                        "serve.prefill": False, "stream.vote": True,
                        "t.param": False}


def test_resolver_skips_ambiguous_defs(tmp_path):
    src = """\
import sys

if sys.platform == "linux":
    def seat(pool, rows):
        return pool.tolist()
else:
    def seat(pool, rows):
        return pool

def build(probe):
    return probe.track("serve.seat", seat)
"""
    assert _port_findings(tmp_path, {"snippet.py": src},
                          "track-donate-pool") == []
    assert _port_findings(tmp_path, {"snippet.py": src},
                          "host-sync-in-cell") == []


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

_CLEAN = "import time\n\n\ndef stamp():\n    return time.perf_counter()\n"
_CLI_CASES = {
    # name: (source, extra argv, baseline text or None, expected exit)
    "clean": (_CLEAN, [], '{"entries": []}', 0),
    "bad": (REF_T._WALL, ["--fail-on-findings"], '{"entries": []}', 1),
    "no_fail": (REF_T._WALL, ["--no-fail"], '{"entries": []}', 0),
    "stale": (_CLEAN, [], json.dumps({"entries": [{
        "rule": "wallclock-ban", "path": "snippet.py",
        "snippet": "return time.time()"}]}), 2),
    "unreadable": (REF_T._WALL, [], "{not json", 2),
}


@pytest.mark.parametrize("case", sorted(_CLI_CASES))
def test_cli_exit_codes_equal(case, tmp_path, capsys):
    src, extra, baseline, want = _CLI_CASES[case]
    snippet, base = tmp_path / "snippet.py", tmp_path / "baseline.json"
    snippet.write_text(src)
    base.write_text(baseline)
    codes, keys = [], []
    for cli in (REF_CLI, PORT_CLI):
        out = tmp_path / f"{cli.__name__}.report.json"
        codes.append(cli.main([str(snippet), "--baseline", str(base),
                               "--json", str(out), *extra]))
        keys.append(sorted(json.loads(out.read_text())) if out.exists()
                    else None)
    assert codes == [want, want]
    assert keys[0] == keys[1]
    assert (keys[0] is None) == (case == "unreadable")
    capsys.readouterr()


def test_cli_defaults(monkeypatch, capsys, tmp_path):
    seen = {}

    def fake_scan(paths, pack, baseline=None, root=None):
        seen.update(paths=list(paths), baseline=baseline, root=root)
        return astpass.ScanResult([], [], [], 1)

    # the defaults are the checkout's, whatever the working directory
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(PORT_CLI.astpass, "scan_paths", fake_scan)
    assert PORT_CLI.main([]) == 0
    assert seen["paths"] == [REPO / "src" / "repro_torch",
                             REPO / "chip_smoke.py"]
    assert seen["root"] == REPO
    assert seen["baseline"] == astpass.load_baseline(
        REPO / "src" / "repro_torch" / "analysis" / "baseline.json")
    assert "1 files, 10 rules: 0 finding(s)" in capsys.readouterr().out


def test_cli_scans_its_own_checkout(tmp_path):
    """A copy of the tree made without `.git` (as `git archive` makes one)
    under a directory that does hold `.git` and a tree of its own: run
    from the copy, the CLI scans the copy, reads the copy's baseline and
    reports paths inside it, and never reads the tree above."""
    import os
    import shutil
    import subprocess
    import sys

    outer = tmp_path
    (outer / ".git").mkdir()
    (outer / "src" / "repro_torch").mkdir(parents=True)
    (outer / "src" / "repro_torch" / "outer.py").write_text(REF_T._WALL)
    (outer / "chip_smoke.py").write_text(REF_T._WALL)
    copy = outer / "checkout"
    shutil.copytree(REPO / "src" / "repro_torch", copy / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "chip_smoke.py", copy / "chip_smoke.py")
    (copy / "src" / "repro_torch" / "planted.py").write_text(REF_T._WALL)
    n_py = len(list((copy / "src" / "repro_torch").rglob("*.py"))) + 1
    report = outer / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json", str(report)],
        cwd=copy, env=dict(os.environ, PYTHONPATH=str(copy / "src")),
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    rec = json.loads(report.read_text())
    assert rec["files_scanned"] == n_py
    assert [(f["rule"], f["path"]) for f in rec["findings"]] == [
        ("wallclock-ban", "src/repro_torch/planted.py")]
    assert rec["stale_baseline"] == []


# ---------------------------------------------------------------------------
# the bench-schema guard
# ---------------------------------------------------------------------------


def _record(name: str) -> dict:
    return json.loads((REPO / name).read_text())


def _set(path, value):
    def mutate(rec):
        *head, last = path
        node = rec
        for k in head:
            node = node[k]
        if value is KeyError:
            del node[last]
        else:
            node[last] = value(node[last]) if callable(value) else value
    return mutate


def _first_cell_violates(rec):
    cells = rec["cell_audit"]["cells"]
    cells[sorted(cells)[0]]["violations"] = ["host callback"]
    rec["cell_audit"]["violations_total"] = 1


_BENCH = sorted(p.name for p in REPO.glob("BENCH_*.json"))
_BROKEN = {
    # name: (record, mutation) — each breaks one rule of the guard
    "no_telemetry": ("BENCH_stream.json", _set(["telemetry"], KeyError)),
    "telemetry_version": ("BENCH_dist.json",
                          _set(["telemetry", "schema_version"], 99)),
    "telemetry_disabled": ("BENCH_decode.json",
                           _set(["telemetry", "enabled"], False)),
    "telemetry_recompiles": ("BENCH_load.json",
                             _set(["telemetry", "recompiles"], KeyError)),
    "frontend_missing": ("BENCH_load.json", _set(["frontend"], KeyError)),
    "frontend_transport": ("BENCH_load.json",
                           _set(["frontend", "transport"], "inproc")),
    "frontend_points": ("BENCH_load.json", _set(["frontend", "points"], [])),
    "frontend_verdict": ("BENCH_load.json",
                         _set(["frontend", "overload"], {})),
    "paged_missing": ("BENCH_decode.json", _set(["paged"], KeyError)),
    "paged_gain": ("BENCH_decode.json",
                   _set(["paged", "concurrency_gain"], 1.5)),
    "paged_bytes": ("BENCH_decode.json",
                    _set(["paged", "paged_cache_bytes_total"],
                         lambda v: v * 100)),
    "paged_leak": ("BENCH_decode.json",
                   _set(["paged", "bytes_in_use", "post_drain_final"],
                        lambda v: v + 1)),
    "paged_recompiles": ("BENCH_decode.json",
                         _set(["paged", "recompiles_after_warmup"], 1)),
    "cell_audit_missing": ("BENCH_dist.json", _set(["cell_audit"], KeyError)),
    "cell_audit_violation": ("BENCH_stream.json", _first_cell_violates),
    "cell_audit_count": ("BENCH_decode.json",
                         _set(["cell_audit", "n_cells"], lambda v: v + 1)),
}


def _both_verdicts(tmp_path, name: str, rec) -> tuple:
    path = tmp_path / name
    path.write_text(json.dumps(rec))
    ref = REF_SCHEMA.check_file(str(path), 1)
    port = check_schema.check_file(str(path), obs.SCHEMA_VERSION)
    return ref, port


@pytest.mark.parametrize("name", _BENCH)
def test_schema_committed_records_agree(name, tmp_path):
    ref, port = _both_verdicts(tmp_path, name, _record(name))
    assert ref == port == []


@pytest.mark.parametrize("case", sorted(_BROKEN))
def test_schema_broken_copies_agree(case, tmp_path):
    name, mutate = _BROKEN[case]
    rec = copy.deepcopy(_record(name))
    mutate(rec)
    ref, port = _both_verdicts(tmp_path, name, rec)
    assert len(port) == len(ref) > 0, (ref, port)


def _report(scanner, pack, src, tmp_path) -> dict:
    p = tmp_path / "snippet.py"
    p.write_text(src)
    res = scanner.scan_paths([p], pack, root=tmp_path)
    return res.to_report(1, pack)


@pytest.mark.parametrize("which", ["port", "reference"])
@pytest.mark.parametrize("state", ["clean", "finding", "stale", "schema",
                                   "no_rules"])
def test_schema_analysis_reports_agree(which, state, tmp_path):
    scanner, pack = ((astpass, RULES) if which == "port"
                     else (ref_astpass, REF_RULES))
    rep = _report(scanner, pack, _CLEAN if state != "finding"
                  else REF_T._WALL, tmp_path)
    if state == "stale":
        rep["stale_baseline"] = [{"rule": "wallclock-ban", "path": "x.py",
                                  "snippet": "gone"}]
    elif state == "schema":
        rep["schema_version"] = 2
    elif state == "no_rules":
        rep["rules"] = []
    ref, port = _both_verdicts(tmp_path, "report.json", rep)
    assert len(port) == len(ref) == (0 if state == "clean" else 1), (ref, port)


def test_schema_cli(tmp_path, capsys):
    good = tmp_path / "BENCH_stream.json"
    good.write_text(json.dumps(_record("BENCH_stream.json")))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert check_schema.main([]) == REF_SCHEMA.main([]) == 2
    assert check_schema.main([str(good)]) == REF_SCHEMA.main([str(good)]) == 0
    assert (check_schema.main([str(good), str(bad)])
            == REF_SCHEMA.main([str(good), str(bad)]) == 1)
    capsys.readouterr()

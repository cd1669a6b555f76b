"""AST scan infrastructure: file walk, rule dispatch, suppression.

Copy of `repro.analysis.astpass` for the port. The rule pack itself
lives in `rules`; this module owns everything around it — parsing each
file once, running every rule over the shared parse, honoring inline
`# repro: allow[rule-id]` pragmas and the checked-in baseline, and
folding the outcome into the JSON report the schema guard
(`repro_torch.benchmarks.check_schema`) validates.

Suppression semantics (both layers keep the gate honest):

  * **Pragma** — `# repro: allow[rule-id] reason` on the flagged line
    or the line directly above it. Scoped to one line and one rule, so
    a pragma can never blanket-silence a file. The syntax is the
    reference's: one pragma silences both scanners, which both read the
    port's files.
  * **Baseline** — `analysis/baseline.json` entries match on
    (rule, file, stripped source text), *not* line numbers, so code
    motion doesn't rot them; every entry must still match a live
    finding or the scan fails with a stale-baseline error (exit 2),
    so fixed code can't leave a dead suppression behind.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Optional

PRAGMA_RE = re.compile(r"#\s*repro:\s*allow\[([a-z0-9-]+)\]")


@dataclasses.dataclass
class Finding:
    """One typed finding: `rule` id, repo-relative `path`, 1-based
    `line`, human `message`, and the stripped source `snippet` (the
    baseline match key). `suppressed_by` is None for live findings,
    else "pragma" or "baseline"."""

    rule: str
    path: str
    line: int
    message: str
    snippet: str
    suppressed_by: Optional[str] = None

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> dict:
        d = {
            "rule": self.rule, "path": self.path, "line": self.line,
            "message": self.message, "snippet": self.snippet,
        }
        if self.suppressed_by:
            d["suppressed_by"] = self.suppressed_by
        return d


@dataclasses.dataclass
class FileInfo:
    """One parsed file handed to every rule: absolute `path`,
    repo-relative `rel`, the `ast` module tree, and raw `lines`."""

    path: Path
    rel: str
    tree: ast.Module
    lines: list

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        snippet = ""
        if 1 <= line <= len(self.lines):
            snippet = self.lines[line - 1].strip()
        return Finding(
            rule=rule, path=self.rel, line=line,
            message=message, snippet=snippet,
        )


@dataclasses.dataclass
class Context:
    """Cross-file state shared by all rules over one scan: the full
    file list (so two-pass rules like driver-thread-affinity can
    collect markers project-wide before flagging call sites), and the
    tracked-cell sites `rules.tracked_sites` resolves once for the
    three cell rules."""

    files: list
    driver_methods: set = dataclasses.field(default_factory=set)
    tracked: Optional[list] = None


@dataclasses.dataclass
class ScanResult:
    findings: list          # live (unsuppressed) findings
    suppressed: list        # findings silenced by pragma/baseline
    stale_baseline: list    # baseline entries matching no finding
    files_scanned: int

    def to_report(self, schema_version: int, rules) -> dict:
        return {
            "report": "analysis",
            "schema_version": schema_version,
            "files_scanned": self.files_scanned,
            "rules": [
                {"id": r.rule_id, "summary": r.summary,
                 "incident": r.incident}
                for r in rules
            ],
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "stale_baseline": list(self.stale_baseline),
        }


def iter_py_files(paths) -> list:
    out = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
    # dedupe, stable order
    seen, uniq = set(), []
    for p in out:
        rp = p.resolve()
        if rp not in seen:
            seen.add(rp)
            uniq.append(p)
    return uniq


def parse_file(path: Path, root: Optional[Path] = None) -> Optional[FileInfo]:
    try:
        src = path.read_text()
        tree = ast.parse(src, filename=str(path))
    except (OSError, SyntaxError):
        return None
    try:
        rel = str(path.resolve().relative_to((root or Path.cwd()).resolve()))
    except ValueError:
        rel = str(path)
    return FileInfo(
        path=path, rel=rel, tree=tree, lines=src.splitlines(),
    )


def pragma_allows(info: FileInfo, finding: Finding) -> bool:
    """True if the flagged line (or the one above) carries a
    `# repro: allow[<rule>]` pragma for this finding's rule."""
    for ln in (finding.line, finding.line - 1):
        if 1 <= ln <= len(info.lines):
            for m in PRAGMA_RE.finditer(info.lines[ln - 1]):
                if m.group(1) == finding.rule:
                    return True
    return False


def load_baseline(path) -> list:
    """Baseline entries: [{"rule", "path", "snippet"}, ...] (any other
    key of an entry, such as its "reason", is not read)."""
    with open(path) as f:
        data = json.load(f)
    entries = data.get("entries", data) if isinstance(data, dict) else data
    out = []
    for e in entries:
        out.append({
            "rule": str(e["rule"]), "path": str(e["path"]),
            "snippet": str(e["snippet"]).strip(),
        })
    return out


def _baseline_key(f: Finding):
    return (f.rule, f.path, f.snippet.strip())


def parse_paths(paths, root: Optional[Path] = None) -> list:
    """A `FileInfo` for every .py under `paths` that parses."""
    infos = []
    for p in iter_py_files(paths):
        info = parse_file(p, root=root)
        if info is not None:
            infos.append(info)
    return infos


def scan_files(infos, rules, baseline=None) -> ScanResult:
    """Run `rules` over parsed files (`parse_paths`); returns live and
    suppressed findings plus any stale baseline entries."""
    ctx = Context(files=list(infos))
    for rule in rules:
        prep = getattr(rule, "prepare", None)
        if prep is not None:
            prep(ctx)

    live, suppressed = [], []
    matched = [False] * len(baseline or [])
    for info in ctx.files:
        for rule in rules:
            for f in rule.check(ctx, info):
                if pragma_allows(info, f):
                    f.suppressed_by = "pragma"
                    suppressed.append(f)
                    continue
                key = _baseline_key(f)
                hit = False
                for i, e in enumerate(baseline or []):
                    if (e["rule"], e["path"], e["snippet"]) == key:
                        matched[i] = hit = True
                if hit:
                    f.suppressed_by = "baseline"
                    suppressed.append(f)
                else:
                    live.append(f)
    stale = [
        e for i, e in enumerate(baseline or []) if not matched[i]
    ]
    live.sort(key=lambda f: (f.path, f.line, f.rule))
    suppressed.sort(key=lambda f: (f.path, f.line, f.rule))
    return ScanResult(
        findings=live, suppressed=suppressed, stale_baseline=stale,
        files_scanned=len(ctx.files),
    )


def scan_paths(paths, rules, baseline=None,
               root: Optional[Path] = None) -> ScanResult:
    """Run `rules` over every .py under `paths`; returns live and
    suppressed findings plus any stale baseline entries."""
    return scan_files(parse_paths(paths, root=root), rules,
                      baseline=baseline)

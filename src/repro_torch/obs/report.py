"""Standalone HTML report for a load-lab record (port of
`repro.obs.report`; it imports nothing of the JAX package).

`render_report(record, out_path)` turns a load-sweep record (the output
of `repro_torch.benchmarks.load_sweep` — serve + stream + frontend
sweeps, knee, SLO burn, lineage samples — or of one launcher sweep with
`--json`) into one self-contained HTML file: inline SVG, no external
assets, no JS dependencies, light/dark via CSS custom properties. Open it
in any browser; nothing to install. Given the same record, the HTML is
byte-identical to the reference's (its footer names the reference's
command for that reason).

Charts rendered per engine:

  * tail-latency-vs-offered-load curves (p50 / p99 / p99.9) with the
    located saturation knee marked and the SLO bound drawn as a
    critical-status reference line;
  * an SLO burn table (ok fraction, error-budget burn rate, verdict
    per offered-load point);
  * a per-request critical-path waterfall from the lineage join
    (queue wait vs per-phase compute).

Every chart is paired with its data table — the numbers are never
color-alone, and the tables are the screen-reader/print fallback.

    python -m repro_torch.obs.report RECORD.json -o load_report.html
"""

from __future__ import annotations

import html
import json
import math
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# palette — categorical slots in fixed order, status-critical for SLO
# bounds, muted ink for queue-wait. Values validated for CVD separation
# against both surfaces; dark mode is its own selected steps, not a flip.
# ---------------------------------------------------------------------------

_CSS = """
:root {
  --surface: #fcfcfb;
  --ink: #1a1a19;
  --ink-2: #5f5c58;
  --ink-3: #8a8783;
  --grid: #e8e6e3;
  --edge: #d9d6d2;
  --s1: #2a78d6;  /* p50  */
  --s2: #eb6834;  /* p99  */
  --s3: #1baf7a;  /* p99.9 */
  --crit: #d03b3b;
  --wait: #b9b5af; /* queue wait in waterfalls — muted, not a series hue */
  --card: #ffffff;
}
@media (prefers-color-scheme: dark) {
  :root {
    --surface: #1a1a19;
    --ink: #f0efed;
    --ink-2: #a8a5a0;
    --ink-3: #7a7772;
    --grid: #2e2d2b;
    --edge: #3a3936;
    --s1: #3987e5;
    --s2: #d95926;
    --s3: #199e70;
    --crit: #e25555;
    --wait: #55524e;
    --card: #222120;
  }
}
* { box-sizing: border-box; }
body {
  margin: 0; padding: 24px; background: var(--surface); color: var(--ink);
  font: 14px/1.5 ui-sans-serif, system-ui, -apple-system, "Segoe UI", sans-serif;
}
main { max-width: 960px; margin: 0 auto; }
h1 { font-size: 20px; margin: 0 0 4px; }
h2 { font-size: 16px; margin: 32px 0 8px; }
h3 { font-size: 14px; margin: 20px 0 6px; color: var(--ink-2); }
p.sub { color: var(--ink-2); margin: 0 0 16px; }
.verdict { display: inline-block; padding: 2px 10px; border-radius: 999px;
  font-size: 12px; font-weight: 600; border: 1px solid var(--edge); }
.verdict.ok { color: var(--s3); }
.verdict.bad { color: var(--crit); }
figure { margin: 12px 0; padding: 12px; background: var(--card);
  border: 1px solid var(--edge); border-radius: 8px; }
figcaption { font-size: 12px; color: var(--ink-2); margin-top: 6px; }
svg text { fill: var(--ink-2); font: 11px ui-sans-serif, system-ui, sans-serif; }
svg .title { fill: var(--ink); font-size: 12px; font-weight: 600; }
svg .lbl { fill: var(--ink); }
table { border-collapse: collapse; width: 100%; font-size: 12px;
  font-variant-numeric: tabular-nums; }
th, td { text-align: right; padding: 4px 8px; border-bottom: 1px solid var(--grid); }
th { color: var(--ink-2); font-weight: 600; }
th:first-child, td:first-child { text-align: left; }
td.ok { color: var(--s3); font-weight: 600; }
td.bad { color: var(--crit); font-weight: 600; }
.legend { display: flex; gap: 16px; font-size: 12px; color: var(--ink);
  margin: 2px 0 6px; flex-wrap: wrap; }
.legend span::before { content: ""; display: inline-block; width: 10px;
  height: 10px; border-radius: 3px; margin-right: 5px; vertical-align: -1px;
  background: var(--sw); }
circle.pt:hover { stroke-width: 3; }
rect.seg:hover { opacity: 0.8; }
footer { margin-top: 40px; font-size: 12px; color: var(--ink-3); }
"""

_SERIES = (  # (record key, label, css var) — fixed categorical order
    ("p50_s", "p50", "--s1"),
    ("p99_s", "p99", "--s2"),
    ("p999_s", "p99.9", "--s3"),
)

_PHASE_VARS = {  # waterfall phases follow the same fixed slot order
    "queue_wait": "--wait",
    "prefill": "--s1",
    "seat": "--s2",
    "decode": "--s3",
    "classify": "--s1",
    "vote": "--s2",
}


# ---------------------------------------------------------------------------
# formatting + scales
# ---------------------------------------------------------------------------


def _fmt_s(x: float) -> str:
    """Latency with a human unit (µs / ms / s)."""
    if x != x:  # nan
        return "–"
    ax = abs(x)
    if ax < 1e-3:
        return f"{x * 1e6:.0f}µs"
    if ax < 1.0:
        return f"{x * 1e3:.2g}ms" if ax < 0.01 else f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def _fmt_rate(x: float) -> str:
    if abs(x) >= 1e6:
        return f"{x / 1e6:.3g}M/s"
    if abs(x) >= 1e3:
        return f"{x / 1e3:.3g}k/s"
    return f"{x:.3g}/s"


def _ticks(lo: float, hi: float, n: int = 5) -> list[float]:
    if not (hi > lo):
        hi = lo + 1.0
    span = hi - lo
    step = 10.0 ** math.floor(math.log10(span / max(n, 1)))
    for m in (1.0, 2.0, 2.5, 5.0, 10.0):
        if span / (step * m) <= n:
            step *= m
            break
    t = math.ceil(lo / step) * step
    out = []
    while t <= hi + 1e-9 * span:
        out.append(round(t, 12))
        t += step
    return out


class _Lin:
    def __init__(self, lo, hi, a, b):
        self.lo, self.hi, self.a, self.b = lo, hi, a, b
        self.span = (hi - lo) or 1.0

    def __call__(self, x: float) -> float:
        return self.a + (x - self.lo) / self.span * (self.b - self.a)


# ---------------------------------------------------------------------------
# charts
# ---------------------------------------------------------------------------


def tail_curve_svg(
    points: Sequence[dict],
    *,
    rate_key: str = "offered_load",
    knee: Optional[dict] = None,
    slo_bound: Optional[float] = None,
    title: str = "tail latency vs offered load",
) -> str:
    """Percentile-vs-load line chart: one y-axis, three fixed-slot
    series, the knee as a dashed marker, the SLO bound in status
    critical. Every point carries a hover <title> tooltip."""
    pts = sorted(points, key=lambda p: p[rate_key])
    if not pts:
        return "<p>no points</p>"
    W, H, L, R, T, B = 640, 300, 64, 16, 30, 44
    xs = [p[rate_key] for p in pts]
    ys = [p[k] for p in pts for k, _, _ in _SERIES if p.get(k) is not None]
    if slo_bound is not None:
        ys.append(slo_bound)
    y_hi = max(ys) * 1.08
    sx = _Lin(min(xs), max(xs), L, W - R)
    sy = _Lin(0.0, y_hi, H - B, T)
    out = [
        f'<svg viewBox="0 0 {W} {H}" role="img" '
        f'aria-label="{html.escape(title)}">',
        f'<text class="title" x="{L}" y="16">{html.escape(title)}</text>',
    ]
    for t in _ticks(0.0, y_hi):
        y = sy(t)
        out.append(
            f'<line x1="{L}" x2="{W - R}" y1="{y:.1f}" y2="{y:.1f}" '
            f'stroke="var(--grid)" stroke-width="1"/>'
            f'<text x="{L - 6}" y="{y + 3.5:.1f}" '
            f'text-anchor="end">{_fmt_s(t)}</text>'
        )
    for t in _ticks(min(xs), max(xs), 6):
        if not (min(xs) <= t <= max(xs)):
            continue
        x = sx(t)
        out.append(
            f'<text x="{x:.1f}" y="{H - B + 16}" '
            f'text-anchor="middle">{_fmt_rate(t)}</text>'
        )
    out.append(
        f'<text x="{(L + W - R) / 2:.0f}" y="{H - 8}" '
        f'text-anchor="middle">offered load</text>'
    )
    if slo_bound is not None:
        y = sy(slo_bound)
        out.append(
            f'<line x1="{L}" x2="{W - R}" y1="{y:.1f}" y2="{y:.1f}" '
            f'stroke="var(--crit)" stroke-width="1.5" '
            f'stroke-dasharray="2 4"/>'
            f'<text x="{W - R}" y="{y - 5:.1f}" text-anchor="end" '
            f'fill="var(--crit)" style="fill:var(--crit)">SLO bound '
            f'{_fmt_s(slo_bound)}</text>'
        )
    if knee and knee.get("detected"):
        x = sx(knee["knee_rate"])
        out.append(
            f'<line x1="{x:.1f}" x2="{x:.1f}" y1="{T}" y2="{H - B}" '
            f'stroke="var(--ink-3)" stroke-width="1.5" '
            f'stroke-dasharray="5 4"/>'
            f'<text class="lbl" x="{x + 5:.1f}" y="{T + 12}">knee '
            f'{_fmt_rate(knee["knee_rate"])}</text>'
        )
    for key, label, var in _SERIES:
        coords = [
            (sx(p[rate_key]), sy(p[key]))
            for p in pts
            if p.get(key) is not None
        ]
        if not coords:
            continue
        d = " ".join(f"{x:.1f},{y:.1f}" for x, y in coords)
        out.append(
            f'<polyline points="{d}" fill="none" '
            f'stroke="var({var})" stroke-width="2" '
            f'stroke-linejoin="round"/>'
        )
        for p in pts:
            if p.get(key) is None:
                continue
            x, y = sx(p[rate_key]), sy(p[key])
            tip = (
                f"{label} = {_fmt_s(p[key])} @ "
                f"{_fmt_rate(p[rate_key])} "
                f"({p.get('load_fraction', '?')}× capacity)"
            )
            out.append(
                f'<circle class="pt" cx="{x:.1f}" cy="{y:.1f}" r="4" '
                f'fill="var({var})" stroke="var(--card)" '
                f'stroke-width="2"><title>{html.escape(tip)}</title>'
                f"</circle>"
            )
        # direct label at the last point
        x, y = coords[-1]
        out.append(
            f'<text class="lbl" x="{min(x + 7, W - 4):.1f}" '
            f'y="{y + 3.5:.1f}" style="fill:var({var})">{label}</text>'
        )
    out.append("</svg>")
    legend = "".join(
        f'<span style="--sw:var({var})">{label}</span>'
        for _, label, var in _SERIES
    )
    return f'<div class="legend">{legend}</div>' + "".join(out)


def waterfall_svg(samples: Sequence[dict], *, title: str) -> str:
    """Per-request critical-path waterfall: queue wait then per-phase
    compute as 2px-gapped horizontal segments, one row per request."""
    rows = [s for s in samples if s.get("total_s")]
    if not rows:
        return "<p>no lineage samples</p>"
    rows = rows[:12]
    ROW, GAP = 18, 6
    W, L, R, T = 640, 170, 16, 30
    H = T + len(rows) * (ROW + GAP) + 34
    total_hi = max(s["total_s"] for s in rows) or 1.0
    sx = _Lin(0.0, total_hi, L, W - R)
    out = [
        f'<svg viewBox="0 0 {W} {H}" role="img" '
        f'aria-label="{html.escape(title)}">',
        f'<text class="title" x="{L}" y="16">{html.escape(title)}</text>',
    ]
    for t in _ticks(0.0, total_hi, 5):
        x = sx(t)
        out.append(
            f'<line x1="{x:.1f}" x2="{x:.1f}" y1="{T}" '
            f'y2="{H - 30}" stroke="var(--grid)"/>'
            f'<text x="{x:.1f}" y="{H - 16}" '
            f'text-anchor="middle">{_fmt_s(t)}</text>'
        )
    seen_phases: list[str] = []
    for i, s in enumerate(rows):
        y = T + i * (ROW + GAP)
        rid = str(s.get("request_id", f"req {i}"))
        out.append(
            f'<text x="{L - 6}" y="{y + ROW - 5}" '
            f'text-anchor="end">{html.escape(rid)}</text>'
        )
        cursor = 0.0
        segs = [("queue_wait", s.get("queue_wait_s", 0.0))]
        segs += list((s.get("phases_s") or {}).items())
        for name, dur in segs:
            if not dur or dur <= 0:
                continue
            if name not in seen_phases:
                seen_phases.append(name)
            x0, x1 = sx(cursor), sx(cursor + dur)
            w = max(x1 - x0 - 2, 1.0)  # 2px surface gap between fills
            var = _PHASE_VARS.get(name, "--ink-3")
            tip = f"{rid}: {name} {_fmt_s(dur)}"
            out.append(
                f'<rect class="seg" x="{x0:.1f}" y="{y}" '
                f'width="{w:.1f}" height="{ROW - 4}" rx="3" '
                f'fill="var({var})"><title>{html.escape(tip)}</title>'
                f"</rect>"
            )
            cursor += dur
    out.append("</svg>")
    legend = "".join(
        f'<span style="--sw:var({_PHASE_VARS.get(n, "--ink-3")})">'
        f"{html.escape(n)}</span>"
        for n in seen_phases
    )
    return f'<div class="legend">{legend}</div>' + "".join(out)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


def _points_table(points: Sequence[dict], rate_key: str) -> str:
    head = (
        "<tr><th>load ×cap</th><th>offered</th><th>achieved</th>"
        "<th>n</th><th>p50</th><th>p99</th><th>p99.9</th>"
        "<th>max</th></tr>"
    )
    body = []
    for p in sorted(points, key=lambda p: p[rate_key]):
        ach = p.get("achieved_rps") or p.get("achieved_rate")
        lat = p.get("latency") or {}
        n = p.get("count") or p.get("n_segments") or p.get("n_requests")
        mx = p.get("max_s", lat.get("max_s", float("nan")))
        body.append(
            "<tr>"
            f"<td>{p.get('load_fraction', '–')}</td>"
            f"<td>{_fmt_rate(p[rate_key])}</td>"
            f"<td>{_fmt_rate(ach) if ach else '–'}</td>"
            f"<td>{n if n is not None else '–'}</td>"
            f"<td>{_fmt_s(p.get('p50_s', float('nan')))}</td>"
            f"<td>{_fmt_s(p.get('p99_s', float('nan')))}</td>"
            f"<td>{_fmt_s(p.get('p999_s', float('nan')))}</td>"
            f"<td>{_fmt_s(mx if mx is not None else float('nan'))}</td>"
            "</tr>"
        )
    return f"<table>{head}{''.join(body)}</table>"


def _slo_table(slo: dict) -> str:
    decl = slo.get("declared", {})
    head = (
        "<tr><th>offered</th><th>total</th><th>ok</th>"
        "<th>ok fraction</th><th>burn rate</th><th>met</th></tr>"
    )
    body = []
    for p in slo.get("points", ()):
        cls = "ok" if p.get("met") else "bad"
        mark = "✓" if p.get("met") else "✗"
        body.append(
            "<tr>"
            f"<td>{_fmt_rate(p['offered_load'])}</td>"
            f"<td>{p['total']}</td><td>{p['ok']}</td>"
            f"<td>{p['ok_fraction']:.4f}</td>"
            f"<td>{p['burn_rate']:.2f}</td>"
            f'<td class="{cls}">{mark}</td>'
            "</tr>"
        )
    name = html.escape(str(decl.get("name", "slo")))
    bound = decl.get("bound")
    target = decl.get("target")
    cap = (
        f"{name}: metric {html.escape(str(decl.get('metric', '?')))}, "
        f"bound {_fmt_s(bound) if bound is not None else '?'}, "
        f"target {target}"
    )
    return (
        f"<table>{head}{''.join(body)}</table>"
        f"<figcaption>{cap}. Burn rate = (1 − ok fraction) / error "
        f"budget; ≤ 1 sustains the target.</figcaption>"
    )


def _verdict_badge(overload: dict) -> str:
    v = str(overload.get("verdict", "unknown"))
    cls = "ok" if v == "graceful_degradation" else "bad"
    return f'<span class="verdict {cls}">{html.escape(v)}</span>'


# ---------------------------------------------------------------------------
# report assembly
# ---------------------------------------------------------------------------


def _engine_section(name: str, sweep: dict, lineage: Optional[dict]) -> str:
    if not sweep:
        return ""
    rate_key = "offered_load"
    knee = sweep.get("knee") or {}
    slo = sweep.get("slo") or {}
    bound = (slo.get("declared") or {}).get("bound")
    # the serve bound is a TTFT latency (plottable); the stream bound is
    # slack >= 0, which has no home on a latency axis
    plot_bound = bound if name == "serve" and bound else None
    co = sweep.get("coordinated_omission_guard") or {}
    overload = sweep.get("overload") or {}
    parts = [
        f"<h2>{name} — open loop "
        f"({html.escape(str(sweep.get('timebase', '?')))} time) "
        f"{_verdict_badge(overload)}</h2>",
        "<figure>",
        tail_curve_svg(
            sweep.get("points", ()),
            rate_key=rate_key,
            knee=knee,
            slo_bound=plot_bound,
            title=f"{name}: tail latency vs offered load",
        ),
    ]
    if knee.get("detected"):
        parts.append(
            f"<figcaption>Saturation knee at "
            f"{_fmt_rate(knee['knee_rate'])} "
            f"(p99 grows {knee['post_knee_growth']:.1f}× past it; "
            f"baseline p99 {_fmt_s(knee['baseline_s'])}).</figcaption>"
        )
    parts += ["</figure>", "<h3>Points</h3>",
              _points_table(sweep.get("points", ()), rate_key)]
    if slo:
        parts += ["<h3>SLO burn</h3>", _slo_table(slo)]
    if co:
        ok = co.get("intended_ge_dequeue")
        parts.append(
            f"<h3>Coordinated-omission guard</h3>"
            f"<p class='sub'>latency measured from <b>intended</b> "
            f"arrival; intended ≥ dequeue held: "
            f"<b>{'yes' if ok else 'NO'}</b>; mean queue excess "
            f"{_fmt_s(co.get('mean_queue_excess_s', float('nan')))}"
            f" over {co.get('samples', '?')} samples at the highest "
            f"load.</p>"
        )
    if lineage and lineage.get("samples"):
        parts += [
            "<h3>Request lineage (critical paths)</h3>",
            "<figure>",
            waterfall_svg(
                lineage["samples"],
                title=f"{name}: queue wait vs compute per request",
            ),
            f"<figcaption>{lineage.get('requests', '?')} requests "
            f"joined; {lineage.get('min_distinct_hops', '?')}–"
            f"{lineage.get('max_distinct_hops', '?')} distinct hops "
            f"each.</figcaption>",
            "</figure>",
        ]
    return "\n".join(parts)


def render_report(record: dict, out_path: str) -> str:
    """Write the self-contained HTML report; returns `out_path`."""
    sections = []
    for name in ("serve", "stream"):
        sweep = record.get(name) or {}
        lin = (record.get("lineage") or {}).get(name)
        sections.append(_engine_section(name, sweep, lin))
    created = record.get("created_unix")
    meta = []
    if record.get("smoke"):
        meta.append("smoke run")
    if created:
        meta.append(f"created_unix {created}")
    tel = record.get("telemetry") or {}
    if tel:
        meta.append(f"telemetry schema v{tel.get('schema_version', '?')}")
    doc = f"""<!doctype html>
<html lang="en">
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>Load lab report</title>
<style>{_CSS}</style>
<body>
<main>
<h1>Load lab — open-loop tail latency, saturation knees, SLO burn</h1>
<p class="sub">Latencies are measured from each request's
<em>intended</em> arrival time (open loop), so queue delay under
overload is charged to the system — coordinated omission is
structurally impossible. {html.escape("; ".join(meta))}</p>
{"".join(sections)}
<footer>Generated by <code>python -m repro.obs.loadlab</code> from a
BENCH_load record. Single file, no external assets; dark mode follows
the OS preference.</footer>
</main>
</body>
</html>
"""
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Render a load-lab HTML report from a load-sweep "
                    "record"
    )
    ap.add_argument("bench", help="path to the load-sweep record (JSON)")
    ap.add_argument("-o", "--out", default="load_report.html")
    args = ap.parse_args(argv)
    with open(args.bench) as f:
        record = json.load(f)
    out = render_report(record, args.out)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

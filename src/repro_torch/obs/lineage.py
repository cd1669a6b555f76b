"""Request lineage: join one request's spans across subsystem hops.

Copy of `repro.obs.lineage` for the port. The tracer records *what*
happened (spans with wall/virtual timestamps and thread-correct parent
edges); this module recovers *to whom*. Every hop the serve engine and the stream fleet emit carries a
request id — a string minted at the moment a request enters the system
(`submit` for serve, `enqueue` for stream) and propagated through every
later hop as a span attr:

  * a single-request event tags `request_id="serve:3"`;
  * a batched hop (an admission group, a packed bucket, a pool decode
    tick) tags `request_ids=[...]` — one span, many requests; the span
    is a hop of *each* of them.

Hop vocabularies (the instrumented paths):

  serve   submit → admit (prefill, seat children) → tick/decode → finish
  stream  enqueue → pack → flush (classify, vote children)

When requests arrive through the serving frontend (`serve.frontend`),
the id is minted CLIENT-side and carried across the wire, and the
transport adds hops of its own: `frontend/ingress` before the entry
hop and `frontend/reply` (LM terminal reply, after `serve/finish`) or
`frontend/ack` (segment admission ack) — so a joined lineage spans the
socket hop, not just the in-process path.

`join` inverts the tagging into {request_id: [hop, ...]} with hops in
timestamp order; `critical_path` folds one request's hops into the
queue-wait / compute / seating attribution the load lab reports, and
`assert_joined` is the acceptance gate: every sampled request's spans
must join into one lineage across at least `min_hops` distinct hops.

Timestamps: hops carry both wall (`ts_s`/`dur_s`, seconds from tracer
epoch) and, where the emitting subsystem models time, virtual
(`v_ts_s`/`v_dur_s`) coordinates. Stream lineages are best read in
virtual time (the modeled fleet timeline); serve lineages in wall time.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

# ---------------------------------------------------------------------------
# request-id minting — the one format every hop and the joiner agree on
# ---------------------------------------------------------------------------


def serve_rid(uid: int) -> str:
    """Request id of one LM serving request (engine `Request.uid`)."""
    return f"serve:{uid}"


def stream_rid(patient: int, seq: int) -> str:
    """Request id of one streamed segment — (patient, seq) is the
    fleet-wide unique identity `data.iegm` keys content on."""
    return f"stream:{patient}:{seq}"


@dataclasses.dataclass(frozen=True)
class Hop:
    """One event on one request's path."""

    name: str
    ts_s: float  # wall seconds from tracer epoch
    dur_s: float
    span_id: int
    parent_id: int
    v_ts_s: Optional[float] = None  # virtual (modeled) coordinates
    v_dur_s: Optional[float] = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def end_s(self) -> float:
        return self.ts_s + self.dur_s


def _event_rids(e: dict) -> list[str]:
    attrs = e.get("attrs") or {}
    rid = attrs.get("request_id")
    if rid is not None:
        return [rid]
    return list(attrs.get("request_ids") or ())


def join(events: Iterable[dict]) -> dict[str, list[Hop]]:
    """{request_id: hops in timestamp order} over a tracer event list
    (the in-memory `tracer.events()` or a parsed JSONL log). Events
    with no request tag are simply not lineage hops."""
    out: dict[str, list[Hop]] = {}
    for e in events:
        rids = _event_rids(e)
        if not rids:
            continue
        attrs = e.get("attrs") or {}
        hop = Hop(
            name=e["name"],
            ts_s=e["ts_us"] / 1e6,
            dur_s=e["dur_us"] / 1e6,
            span_id=int(e.get("span_id", 0)),
            parent_id=int(e.get("parent_id", 0)),
            v_ts_s=attrs.get("v_ts_s"),
            v_dur_s=attrs.get("v_dur_s"),
            attrs=attrs,
        )
        for rid in rids:
            out.setdefault(rid, []).append(hop)
    for hops in out.values():
        hops.sort(key=lambda h: (h.ts_s, h.span_id))
    return out


# hop-name → attribution phase. Child spans (prefill/seat under admit,
# classify/vote under flush) refine their parent's interval, so the
# parent hops are deliberately NOT phases of their own.
_PHASE_OF = {
    "serve/prefill": "prefill",
    "serve/seat": "seat",
    "serve/decode": "decode",
    "stream/classify": "classify",
    "stream/vote": "vote",
}
_ENTRY_HOPS = ("frontend/ingress", "serve/submit", "stream/enqueue")
# `frontend/reply` is the LM terminal reply (strictly after
# serve/finish); the segment ack is deliberately NOT an exit hop — it
# precedes the segment's stream hops in wall time
_EXIT_HOPS = ("serve/finish", "frontend/reply")


def critical_path(hops: list[Hop]) -> dict:
    """Fold one request's hops into an end-to-end attribution:

      * `queue_wait_s` — entry (submit/enqueue) until the first span
        that actually works on the request;
      * per-phase compute seconds (prefill / seat / decode for serve,
        classify / vote for stream), summed over every tagged span;
      * `total_s` — entry until the last hop ends (the finish instant
        for serve; the last span end for stream).

    Wall coordinates; a stream lineage additionally reports
    `v_total_s` from the virtual track when every hop carries one."""
    if not hops:
        return {"hops": 0}
    entry = next((h for h in hops if h.name in _ENTRY_HOPS), hops[0])
    worked = [h for h in hops if h.name in _PHASE_OF]
    first_work = min(
        (h.ts_s for h in worked), default=entry.ts_s
    )
    finish = next(
        (h for h in reversed(hops) if h.name in _EXIT_HOPS), None
    )
    end = finish.ts_s if finish is not None else max(
        h.end_s for h in hops
    )
    phases: dict[str, float] = {}
    for h in worked:
        key = _PHASE_OF[h.name]
        phases[key] = phases.get(key, 0.0) + h.dur_s
    out = {
        "hops": len(hops),
        "hop_names": [h.name for h in hops],
        "t_entry_s": entry.ts_s,
        "queue_wait_s": max(first_work - entry.ts_s, 0.0),
        "phases_s": phases,
        "total_s": max(end - entry.ts_s, 0.0),
    }
    v_entry = entry.v_ts_s
    v_ends = [
        h.v_ts_s + (h.v_dur_s or 0.0)
        for h in hops
        if h.v_ts_s is not None
    ]
    if v_entry is not None and v_ends:
        out["v_total_s"] = max(max(v_ends) - v_entry, 0.0)
    return out


def summarize(events: Iterable[dict]) -> dict:
    """Lineage roll-up for a BENCH record: how many requests joined,
    the hop-count distribution, and min/max distinct hops."""
    lineages = join(events)
    if not lineages:
        return {"requests": 0}
    distinct = [len({h.name for h in hops}) for hops in lineages.values()]
    with_transport = sum(
        1 for hops in lineages.values()
        if any(h.name.startswith("frontend/") for h in hops)
    )
    return {
        "requests": len(lineages),
        "min_distinct_hops": min(distinct),
        "max_distinct_hops": max(distinct),
        "mean_hops": sum(len(h) for h in lineages.values())
        / len(lineages),
        "requests_with_transport_hop": with_transport,
    }


def assert_joined(
    events: Iterable[dict], *, min_hops: int = 3,
    expect_prefix: Optional[str] = None,
) -> dict[str, list[Hop]]:
    """The acceptance gate: every request id seen anywhere in `events`
    joins into one lineage with >= `min_hops` *distinct* hop names.
    Returns the join so callers can keep using it."""
    lineages = join(events)
    if not lineages:
        raise AssertionError("no request lineage in trace — "
                             "request-id tagging is dark")
    for rid, hops in lineages.items():
        if expect_prefix and not rid.startswith(expect_prefix):
            continue
        names = {h.name for h in hops}
        if len(names) < min_hops:
            raise AssertionError(
                f"request {rid!r} joined only {sorted(names)} "
                f"(< {min_hops} distinct hops)"
            )
    return lineages


# package-level alias: `obs.join_lineage` reads better than a bare
# `join` next to the other re-exports
join_lineage = join

__all__ = [
    "Hop",
    "assert_joined",
    "critical_path",
    "join",
    "join_lineage",
    "serve_rid",
    "stream_rid",
    "summarize",
]

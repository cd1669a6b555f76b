"""Structured span tracer: JSONL event log + Chrome/Perfetto export.

Copy of `repro.obs.trace` for the port (pure Python).

One `Tracer` per process collects begin/end spans and instant events
under a lock. Events are plain dicts with a fixed schema
(`validate_event`), streamed to a JSONL file on `write_jsonl` and
exported as a Chrome trace-event JSON (`export_chrome`) that
chrome://tracing and https://ui.perfetto.dev load directly.

Span nesting: every span/instant gets a process-unique `span_id` and
the `parent_id` of the innermost span open *on its own thread* — the
open-span stack lives in thread-local storage, so spans opened from
worker threads parent to their own thread's enclosing span, never to
whatever the main thread happens to have open (a process-global stack
would cross-wire parent edges the moment two threads trace at once;
`obs.lineage` joins per-request critical paths along these edges,
so they must be right). `parent_id == 0` marks a root span.

Virtual time: subsystems that model time (the stream fleet's
virtual-time loop) pass `v_ts_s`/`v_dur_s` span attributes; the Chrome
export then mirrors those spans onto a second process track named
"virtual time" with the modeled timestamps, so one trace shows the wall
timeline and the modeled fleet timeline side by side.

A disabled tracer returns one shared no-op context manager from
`span()` — the hot-path cost of an un-traced span is a dict miss and a
`with` statement, nanoseconds per call.

Deferred building (not in the reference): an enabled hot loop may time
its spans itself with `time.perf_counter()` and hand the times over
later — `Tracer.record` after the loop, or a drain registered with
`Tracer.defer` that the tracer calls when its events are read — and an
attribute value may be a `LazyAttr`, resolved on reading; the event
dicts and strings are then built outside the loop. The stream fleet and
its scheduler do all three: building the events inside their loop cost
more than the enabled-telemetry budget.

CLI: validate a JSONL event log and a Chrome
export in one call —

    python -m repro_torch.obs.trace TRACE.jsonl TRACE.json
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Callable

EVENT_TYPES = ("span", "instant", "counter")

ROOT_SPAN_ID = 0  # parent_id of a span with no enclosing span

# chrome trace-event pids: wall-clock events vs virtual-time mirrors
WALL_PID = 0
VIRTUAL_PID = 1


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        """No-op twin of `_Span.set` (late attrs on a disabled span)."""
        return self


NULL_SPAN = _NullSpan()


class LazyAttr:
    """An event attribute value built when the events are read:
    `resolve()` returns the plain (JSON-ready) value."""

    __slots__ = ()

    def resolve(self):
        raise NotImplementedError


class _Span:
    __slots__ = ("tracer", "name", "cat", "attrs", "_t0",
                 "span_id", "parent_id")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 attrs: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def set(self, **attrs):
        """Attach attrs discovered mid-span (e.g. the request ids a
        pack decided on) — recorded at `__exit__` with the rest."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        stack = self.tracer.open_stack()
        self.span_id = self.tracer._next_id()
        self.parent_id = stack[-1] if stack else ROOT_SPAN_ID
        stack.append(self.span_id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        stack = self.tracer.open_stack()
        # tolerate a mis-nested exit rather than corrupting the stack
        if stack and stack[-1] == self.span_id:
            stack.pop()
        elif self.span_id in stack:
            del stack[stack.index(self.span_id):]
        self.tracer._record(
            type="span",
            name=self.name,
            cat=self.cat,
            ts_us=(self._t0 - self.tracer._t0) * 1e6,
            dur_us=(t1 - self._t0) * 1e6,
            span_id=self.span_id,
            parent_id=self.parent_id,
            attrs=self.attrs,
        )
        return False


class Tracer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._t0 = time.perf_counter()
        # span ids are process-unique (itertools.count.__next__ is a
        # single C call — atomic under the GIL); the OPEN-span stack is
        # per-thread so parent edges never cross threads
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._drains: list[Callable[[], list[tuple]]] = []
        self._settled = 0  # events before this index hold no LazyAttr

    def _next_id(self) -> int:
        return next(self._ids)

    def open_stack(self) -> list:
        """This thread's stack of open span ids (innermost last)."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    # -- emission -----------------------------------------------------------

    def span(self, name: str, cat: str = "app", **attrs):
        """Context manager timing one named region. Extra kwargs become
        the event's `attrs`; `v_ts_s`/`v_dur_s` (virtual-time seconds)
        additionally place the span on the virtual-time track of the
        Chrome export."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, attrs)

    def instant(self, name: str, cat: str = "app", **attrs) -> None:
        if not self.enabled:
            return
        stack = self.open_stack()
        self._record(
            type="instant",
            name=name,
            cat=cat,
            ts_us=(time.perf_counter() - self._t0) * 1e6,
            dur_us=0.0,
            span_id=self._next_id(),
            parent_id=stack[-1] if stack else ROOT_SPAN_ID,
            attrs=attrs,
        )

    def counter(self, name: str, value: float, cat: str = "app") -> None:
        """Chrome 'C'-phase counter sample (renders as an area chart)."""
        if not self.enabled:
            return
        self._record(
            type="counter",
            name=name,
            cat=cat,
            ts_us=(time.perf_counter() - self._t0) * 1e6,
            dur_us=0.0,
            attrs={"value": float(value)},
        )

    def record(self, name: str, cat: str, t0: float, t1: float,
               parent_id: int, **attrs) -> int:
        """Record a finished span that a hot loop timed itself
        (`time.perf_counter()` at its start and end) and returns its id,
        for its children's `parent_id`."""
        if not self.enabled:
            return ROOT_SPAN_ID
        span_id = self._next_id()
        self._record(
            type="span", name=name, cat=cat,
            ts_us=(t0 - self._t0) * 1e6, dur_us=(t1 - t0) * 1e6,
            span_id=span_id, parent_id=parent_id, attrs=attrs,
        )
        return span_id

    def defer(self, drain: Callable[[], list[tuple]]) -> None:
        """Register `drain`: it returns the events its emitter has
        buffered since its last call, as (name, cat, t0, t1, parent_id,
        tid, attrs) tuples of `time.perf_counter()` times (t1 None for
        an instant), and they join the events each time the events are
        read."""
        if not self.enabled:
            return
        with self._lock:
            self._drains.append(drain)

    def _record(self, **event) -> None:
        event["tid"] = threading.get_ident() & 0xFFFF
        with self._lock:
            self._events.append(event)

    def _settle(self) -> None:
        """Record the deferred instants and resolve the lazy attributes
        of the events recorded since the last read (lock held)."""
        for drain in self._drains:
            for name, cat, t0, t1, parent_id, tid, attrs in drain():
                self._events.append({
                    "type": "instant" if t1 is None else "span",
                    "name": name, "cat": cat,
                    "ts_us": (t0 - self._t0) * 1e6,
                    "dur_us": 0.0 if t1 is None else (t1 - t0) * 1e6,
                    "span_id": self._next_id(), "parent_id": parent_id,
                    "attrs": attrs, "tid": tid,
                })
        for e in self._events[self._settled:]:
            attrs = e["attrs"]
            for k, v in attrs.items():
                if isinstance(v, LazyAttr):
                    attrs[k] = v.resolve()
        self._settled = len(self._events)

    # -- introspection ------------------------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            self._settle()
            return list(self._events)

    # -- export -------------------------------------------------------------

    def write_jsonl(self, path: str) -> int:
        """One event per line, schema per `validate_event`. Returns the
        event count."""
        evs = self.events()
        with open(path, "w") as f:
            for e in evs:
                f.write(json.dumps(e) + "\n")
        return len(evs)

    def export_chrome(self, path: str) -> int:
        """Chrome trace-event format (the JSON-object flavor Perfetto
        and chrome://tracing both accept). Returns the traceEvent
        count."""
        out = [
            {"ph": "M", "pid": WALL_PID, "name": "process_name",
             "args": {"name": "wall clock"}},
            {"ph": "M", "pid": VIRTUAL_PID, "name": "process_name",
             "args": {"name": "virtual time (modeled)"}},
        ]
        for e in self.events():
            base = {
                "name": e["name"],
                "cat": e["cat"],
                "pid": WALL_PID,
                "tid": e["tid"],
                "ts": e["ts_us"],
                "args": e["attrs"],
            }
            if e["type"] == "span":
                out.append({**base, "ph": "X", "dur": e["dur_us"]})
                v_ts = e["attrs"].get("v_ts_s")
                if v_ts is not None:
                    out.append({
                        **base,
                        "ph": "X",
                        "pid": VIRTUAL_PID,
                        "ts": float(v_ts) * 1e6,
                        "dur": float(
                            e["attrs"].get("v_dur_s") or 0.0
                        ) * 1e6,
                    })
            elif e["type"] == "instant":
                out.append({**base, "ph": "i", "s": "t"})
            elif e["type"] == "counter":
                out.append({
                    **base, "ph": "C",
                    "args": {"value": e["attrs"].get("value", 0.0)},
                })
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)
        return len(out)


class _NullTracer:
    __slots__ = ()
    enabled = False

    def span(self, name, cat="app", **attrs):
        return NULL_SPAN

    def instant(self, name, cat="app", **attrs):
        pass

    def counter(self, name, value, cat="app"):
        pass

    def record(self, name, cat, t0, t1, parent_id, **attrs):
        return ROOT_SPAN_ID

    def defer(self, drain):
        pass

    def events(self):
        return []

    def write_jsonl(self, path):
        with open(path, "w"):
            pass
        return 0

    def export_chrome(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)
        return 0


NULL_TRACER = _NullTracer()


# ---------------------------------------------------------------------------
# schema validation (the trace smoke)
# ---------------------------------------------------------------------------


def validate_event(e: dict) -> None:
    """Raise ValueError if `e` is not a well-formed trace event."""
    if not isinstance(e, dict):
        raise ValueError(f"event is not an object: {e!r}")
    for key, typ in (
        ("type", str), ("name", str), ("cat", str),
        ("ts_us", (int, float)), ("dur_us", (int, float)),
        ("tid", int), ("attrs", dict),
    ):
        if key not in e:
            raise ValueError(f"event missing {key!r}: {e!r}")
        if not isinstance(e[key], typ):
            raise ValueError(
                f"event field {key!r} has type "
                f"{type(e[key]).__name__}, wanted {typ}: {e!r}"
            )
    if e["type"] not in EVENT_TYPES:
        raise ValueError(f"unknown event type {e['type']!r}")
    if e["ts_us"] < 0 or e["dur_us"] < 0:
        raise ValueError(f"negative timestamp/duration: {e!r}")
    # span_id/parent_id: optional (absent in pre-lineage traces) but
    # typed when present; a span must never parent itself
    for key in ("span_id", "parent_id"):
        if key in e and not isinstance(e[key], int):
            raise ValueError(
                f"event field {key!r} has type "
                f"{type(e[key]).__name__}, wanted int: {e!r}"
            )
    if "span_id" in e and e.get("parent_id") == e["span_id"]:
        raise ValueError(f"self-parenting span: {e!r}")


def validate_jsonl(path: str) -> int:
    """Validate every line of a JSONL event log; returns event count."""
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError as err:
                raise ValueError(
                    f"{path}:{lineno}: not JSON: {err}"
                ) from err
            try:
                validate_event(e)
            except ValueError as err:
                raise ValueError(f"{path}:{lineno}: {err}") from err
            n += 1
    return n


def validate_chrome(path: str) -> int:
    """Validate a Chrome trace export is well-formed; returns the
    traceEvent count."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: missing traceEvents")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError(f"{path}: traceEvents is not a list")
    for i, e in enumerate(evs):
        if not isinstance(e, dict) or "ph" not in e or "name" not in e:
            raise ValueError(f"{path}: traceEvents[{i}] malformed: {e!r}")
        if e["ph"] in ("X", "i", "C") and "ts" not in e:
            raise ValueError(f"{path}: traceEvents[{i}] missing ts")
    return len(evs)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="validate a telemetry JSONL event log and/or a "
                    "Chrome trace export (trace smoke)"
    )
    ap.add_argument("jsonl", help="JSONL event log path")
    ap.add_argument("chrome", nargs="?", default=None,
                    help="Chrome trace.json path")
    args = ap.parse_args()
    n = validate_jsonl(args.jsonl)
    print(f"[obs.trace] {args.jsonl}: {n} events valid")
    if n == 0:
        raise SystemExit(f"{args.jsonl}: no events — tracing was off?")
    if args.chrome:
        m = validate_chrome(args.chrome)
        print(f"[obs.trace] {args.chrome}: {m} traceEvents well-formed")
        if m == 0:
            raise SystemExit(f"{args.chrome}: empty trace")


if __name__ == "__main__":
    main()

"""Async serving frontend: one transport in front of both engines.

Port of `repro.serve.frontend`. The engines run on the card: the driver
thread ticks the LM engine and runs the stream side's classify (the
`nm_spmm` kernel on the runner's ``kernel`` path) and vote update there,
with autograd off (grad mode is per thread). Segment signal content is
synthesized on the host (`stream.sources.FleetSource.signals`) and the
runner copies each packed batch to its device.

Everything before this module drives requests from inside the process;
this is the boundary where they arrive from outside. One asyncio
frontend feeds

  * LM decode requests into the slot engine (`serve.engine.Engine`, or
    `serve.sharded.ShardedEngine` over a mesh), and
  * patient segment arrivals into the stream fleet's micro-batch
    scheduler (`stream.scheduler.MicroBatchScheduler`; its runner's
    buckets split over a data mesh where it has one),

over two interchangeable transports: length-prefixed JSON frames on a
TCP socket (`SocketClient`), and an in-process client (`InProcClient`)
that enters the exact same message handler — tests and the load lab
drive both paths through one code path and can price the socket hop.

Wire format — every frame is a 4-byte big-endian length followed by a
UTF-8 JSON object:

  client -> server
    {"type": "lm", "uid": int, "prompt": [int...],
     "max_new": int, "eos": int|null}
    {"type": "segment", "patient": int, "seq": int,
     "deadline_rel_s": float, "urgent": bool}
    {"type": "drain"}
  server -> client
    {"type": "lm_result", "uid": int, "status": "completed",
     "tokens": [int...]}
    {"type": "lm_result", "uid": int, "status": "rejected",
     "reason": "admission_rate"|"queue_full"|"invalid"
               |"pages_exhausted",
     "detail": str}
    {"type": "segment_ack", "patient": int, "seq": int,
     "status": "enqueued"|"deferred", "urgent": bool}
    {"type": "drained", "stats": {...}}

Threading: the engines are NOT thread-safe, so the frontend owns the
only thread that touches them — a single driver thread that drains an
ingress inbox, submits/ticks the LM engine, and flushes the stream
scheduler on its size/time triggers. The asyncio event loop owns the
sockets and the admission decision; replies cross back via
`loop.call_soon_threadsafe`. Segment *content* is never shipped: like
`fleet.simulate`, signal content is derived from (patient, seq) by the
deterministic iegm synthesizer, so a segment frame is metadata only.

One driver, many ranks: the port runs one process a device, and a
sharded engine's tick or a mesh runner's classify holds collectives, so
every rank must make the same engine calls in the same order. Rank 0
runs the frontend and owns everything that depends on the clock or the
socket (the token buckets, deferral, the stream scheduler, the vote);
its driver sends over `records` (`RankRecords`: a gloo group of every
rank) a record of each pass's LM side — the requests it submits and
whether it ticks (`{"submit": [...], "tick": bool}`) — and one of each
bucket it flushes (`{"flush": (patients, seqs)}`), each before the tick
or classify it names, and `{"stop": True}` last. The other ranks build the same
engine and runner, `warm()` in lockstep, then `follow(records)`: each
record's `submit` / `tick` / `classify` calls, replayed. Submits touch
only host state, so rank 0 validates them first; a refusal is
deterministic and falls the same way on every rank, and only rank 0
replies. Outputs are read on rank 0 (the sharded engine all-gathers the
tokens over `data`, the runner its predictions). A follower synthesizes
a bucket's signals from (patients, seqs) through its own seeded
`FleetSource`: no signal crosses the wire. An idle rank 0 sends an empty
record every `HEARTBEAT_S`, so a follower's blocking receive never
meets the group's timeout.

The load lab's sweeps over a mesh (`launch.serve --load-sweep /
--frontend-sweep --mesh`) use the same records without a socket: rank 0
drives its engine through a `RecordedEngine`, which sends each tick's
record (the requests submitted since the last one, then the tick) before
the engine runs it, and announces each frontend it builds
(`{"frontend": cfg}`) before warming it; the other ranks run
`follow_sweep`, which replays the ticks and, at an announcement, builds
and warms the same frontend and `follow`s it to its stop.

Backpressure and admission — every ingress decision is explicit, never
a silent drop:

  * LM requests pass a token bucket at `admission_rate_rps` (wire it
    to the load lab's measured saturation knee) with
    `admission_burst` depth, then a bounded pending-set
    (`lm_queue_limit`). Exceeding either sheds the request with a
    typed `rejected` reply (reason `admission_rate` / `queue_full`);
    engine-level validation failures (empty prompt, max_new <= 0,
    duplicate uid) come back as reason `invalid`. Every accepted
    request terminates in exactly one `completed` XOR `rejected`
    reply: submitted == completed + rejected, always.
  * stream ROUTINE segments pass their own bucket
    (`stream_rate_rps`); over-rate routine traffic is *deferred* —
    acked `deferred`, parked in an unbounded deferral queue, and
    released into the scheduler as the bucket refills (or immediately
    at drain). Deferral is a delay, never a drop.
  * stream URGENT segments always pass, at any load: they bypass the
    bucket entirely and additionally mark their patient urgent so the
    scheduler packs them ahead of every routine segment.

Lineage: request ids are minted CLIENT-side (`serve:{uid}` /
`stream:{patient}:{seq}`) and carried across the wire; the frontend
tags `frontend/ingress` and `frontend/reply` instants with them, so
`obs.lineage.assert_joined` spans the transport hop: a served LM
request joins frontend/ingress -> serve/submit -> serve/admit
(prefill/seat) -> serve/decode -> serve/finish -> frontend/reply.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import queue
import struct
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

import torch

from repro_torch import obs
from repro_torch.obs.lineage import serve_rid, stream_rid

_HEADER = struct.Struct(">I")

STATUS_COMPLETED = "completed"
STATUS_REJECTED = "rejected"
REASON_ADMISSION = "admission_rate"
REASON_QUEUE_FULL = "queue_full"
REASON_INVALID = "invalid"
REASON_PAGES = "pages_exhausted"


def encode_frame(msg: dict, *, max_frame_bytes: int = 1 << 20) -> bytes:
    """One wire frame: 4-byte big-endian length + UTF-8 JSON body."""
    body = json.dumps(msg, separators=(",", ":")).encode()
    if len(body) > max_frame_bytes:
        raise ValueError(
            f"frame of {len(body)} bytes exceeds the "
            f"{max_frame_bytes}-byte limit"
        )
    return _HEADER.pack(len(body)) + body


async def read_frame(
    reader: asyncio.StreamReader, *, max_frame_bytes: int = 1 << 20
) -> Optional[dict]:
    """Read one frame; None on clean EOF at a frame boundary."""
    try:
        hdr = await reader.readexactly(_HEADER.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (length,) = _HEADER.unpack(hdr)
    if length > max_frame_bytes:
        raise ValueError(
            f"incoming frame of {length} bytes exceeds the "
            f"{max_frame_bytes}-byte limit"
        )
    body = await reader.readexactly(length)
    return json.loads(body.decode())


class TokenBucket:
    """Deterministic admission control: `rate` tokens/s refill up to a
    depth of `burst`; each admitted request spends one token. With
    arrivals spaced >= 1/rate apart the bucket never rejects; a burst
    of n back-to-back arrivals admits exactly
    min(n, floor(available)) — a property the shedding tests lean on,
    which is why this is a token bucket and not a noisy sliding-window
    rate estimate."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0 or burst < 1:
            raise ValueError(
                f"need rate > 0 and burst >= 1, got {rate}/{burst}"
            )
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t = clock()

    def try_take(self) -> bool:
        now = self._clock()
        self._tokens = min(
            self.burst, self._tokens + (now - self._t) * self.rate
        )
        self._t = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Knobs for one frontend instance. `admission_rate_rps` is the LM
    shed rate — wire it to the load lab's knee (`obs.loadlab.sweep_serve`'s
    `knee_rate`); None disables shedding. `stream_rate_rps` bounds
    ROUTINE segment admission the same way; URGENT traffic ignores it.
    """

    # LM ingress
    lm_queue_limit: int = 256
    admission_rate_rps: Optional[float] = None
    admission_burst: float = 8.0
    # stream ingress
    stream_rate_rps: Optional[float] = None
    stream_burst: float = 8.0
    stream_buckets: tuple = (4, 8)
    stream_max_wait_s: float = 0.05
    seg_deadline_rel_s: float = 0.5
    # loop cadences
    idle_poll_s: float = 0.001
    deferral_poll_s: float = 0.002
    max_frame_bytes: int = 1 << 20


# seconds an idle rank 0 waits before an empty record (with `records`)
HEARTBEAT_S = 60.0


class RankRecords:
    """The driver's records between ranks: `send` on rank 0 (the
    `Frontend`'s `records=`), `recv` on the others (`Frontend.follow`).
    Each record is pickled and broadcast from rank 0 over a gloo group of
    every rank of the default group, made here — so every rank constructs
    this at the same point, even where the tensors go over NCCL (whose
    object broadcast needs CUDA tensors and the device set in the sending
    thread). `timeout_s` bounds each broadcast; rank 0's heartbeat
    (`HEARTBEAT_S`) keeps an idle follower's receive inside it."""

    def __init__(self, timeout_s: float):
        import datetime

        import torch.distributed as dist

        self._dist = dist
        self.group = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))

    def send(self, record: dict) -> None:
        self._dist.broadcast_object_list([record], src=0, group=self.group)

    def recv(self) -> dict:
        box = [None]
        self._dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


class RecordedEngine:
    """Rank 0's engine in a sweep over a mesh: `submit` runs at once (a
    refusal raises here, and nothing is recorded) and is recorded; each
    `tick` sends the submits since the last one and the tick to the other
    ranks (`follow_sweep`) before the engine runs it. Everything else is
    the engine's."""

    def __init__(self, engine, records):
        self._engine = engine
        self._records = records
        self._submits: list = []

    def submit(self, req) -> None:
        self._engine.submit(req)
        self._submits.append((req.uid, torch.as_tensor(req.prompt).tolist(),
                              req.max_new, req.eos))

    def tick(self) -> int:
        self._records.send({"submit": self._submits, "tick": True})
        self._submits = []
        return self._engine.tick()

    def run(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if self.tick() == 0 and not self._engine._queue:
                break

    def __getattr__(self, name):
        return getattr(self._engine, name)


def follow_sweep(engine, records, make_frontend: Callable) -> None:
    """A rank other than 0 of a sweep over a mesh: replay rank 0's records
    until its stop — each record's submits and tick on `engine`, and at a
    `{"frontend": cfg}` record, the frontend `make_frontend(cfg)` builds
    and warms, followed (`Frontend.follow`) until that frontend's stop."""
    from repro_torch.serve.engine import Request

    while True:
        rec = records.recv()
        if rec.get("stop"):
            return
        if "frontend" in rec:
            make_frontend(rec["frontend"]).follow(records)
            continue
        for uid, prompt, max_new, eos in rec.get("submit", ()):
            engine.submit(Request(uid=uid, prompt=torch.tensor(
                prompt, dtype=torch.long), max_new=max_new, eos=eos))
        if rec.get("tick"):
            engine.tick()


class Frontend:
    """The transport + admission layer. Construct with an `Engine`, a
    stream side (`n_patients` > 0, optionally a
    `FleetRunner` for real classify/vote on flush), or both; then
    `await start()` — with a host, it also listens on a TCP socket.
    The frontend owns the single driver thread that touches the
    engines; never call `engine.tick()` elsewhere while it runs."""

    def __init__(self, *, engine=None, n_patients: int = 0, runner=None,
                 cfg: FrontendConfig = FrontendConfig(),
                 clock: Callable[[], float] = time.monotonic,
                 records=None):
        if engine is None and n_patients <= 0:
            raise ValueError("frontend needs an engine, a stream side "
                             "(n_patients > 0), or both")
        self.engine = engine
        self.cfg = cfg
        self._clock = clock
        # rank 0 of a mesh: where each driver record goes (its `send`),
        # ahead of the engine calls it names; None on one device
        self._records = records
        self._lm_bucket = (
            TokenBucket(cfg.admission_rate_rps, cfg.admission_burst,
                        clock)
            if cfg.admission_rate_rps is not None else None
        )
        self._seg_bucket = (
            TokenBucket(cfg.stream_rate_rps, cfg.stream_burst, clock)
            if cfg.stream_rate_rps is not None else None
        )
        self._sched = None
        self._runner = runner
        self._vstate = None
        self._source = None
        self.n_patients = n_patients
        if n_patients > 0:
            from repro_torch.stream.scheduler import (
                MicroBatchScheduler, SchedulerConfig,
            )

            self._sched = MicroBatchScheduler(
                SchedulerConfig(
                    buckets=tuple(sorted(cfg.stream_buckets)),
                    deadline_s=cfg.seg_deadline_rel_s,
                    max_wait_s=cfg.stream_max_wait_s,
                ),
                n_patients,
            )
            if runner is not None:
                from repro_torch.stream import vote
                from repro_torch.stream.sources import (
                    FleetSource, SourceConfig,
                )

                self._vstate = vote.init(n_patients, device=runner.device)
                # content is derived from (patient, seq) — all-normal
                # keeps vote-driven urgency out of the client-marked
                # priority the shedding tests assert on
                self._source = FleetSource(
                    SourceConfig(n_patients=n_patients, seed=0,
                                 va_fraction=0.0)
                )
        # client-marked urgency (sticky per patient); OR-ed with the
        # vote layer's bitmap after every flush
        self._client_urgent = np.zeros(max(n_patients, 1), bool)
        # terminal-reply callbacks for accepted LM requests, keyed by
        # uid — membership doubles as the bounded ingress queue
        self._pending_lm: dict[int, Callable[[dict], None]] = {}
        self._deferred: list[tuple] = []  # parked ROUTINE segments
        self._inbox: queue.SimpleQueue = queue.SimpleQueue()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._driver: Optional[threading.Thread] = None
        self._driver_err: Optional[BaseException] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._stopping = False
        self._epoch = 0.0
        # split counters: `_c_loop` is touched only on the event-loop
        # thread, `_c_drv` only on the driver thread — `stats()` merges
        self._c_loop: dict[str, int] = {}
        self._c_drv: dict[str, int] = {}

    # -- lifecycle ----------------------------------------------------------

    def warm(self, prompt_len: int = 6) -> None:
        """Run every cell a load point can hit BEFORE the clock starts:
        the engine's admission, chunk cell and pool decode
        (`loadlab.warm_engine`) and the stream side's per-bucket
        signal-synth / classify / vote cells (kernel builds, library
        autotuning, allocator growth). Without this the first flush pays
        for them inside the driver thread mid-run, stalling LM ticks and
        fabricating a latency tail. Call before `start()` — it touches
        the engines from the calling thread."""
        if self._driver is not None:
            raise RuntimeError("warm() must run before start(): the "
                               "driver thread owns the engines once "
                               "it is up")
        if self.engine is not None:
            from repro_torch.obs.loadlab import warm_engine

            warm_engine(self.engine, prompt_len)
        if self._runner is not None:
            from repro_torch.stream import vote

            for b in sorted(set(self.cfg.stream_buckets)):
                sigs = self._source.signals(
                    np.zeros(b, np.int64), np.zeros(b, np.int64)
                )
                preds = self._runner.classify(sigs["signal"])
                # all-invalid batch: the state is unchanged
                _st, _e, _d, urgent = vote.update(
                    self._vstate,
                    np.zeros((b,), np.int64),
                    preds,
                    np.zeros((b,), bool),
                )
                obs.synchronize(urgent)

    async def start(self, host: Optional[str] = "127.0.0.1",
                    port: int = 0):
        """Start the driver thread (+ TCP server when `host` is not
        None). Returns the bound (host, port) or None for in-process
        only."""
        self._loop = asyncio.get_running_loop()
        self._epoch = self._clock()
        self._stopping = False
        # the current card is per thread: the driver takes this one's
        dev = getattr(self.engine or self._runner, "device", None)
        self._card = (torch.cuda.current_device()
                      if dev is not None and dev.type == "cuda" else None)
        self._driver = threading.Thread(
            target=self._drive, name="frontend-driver", daemon=True
        )
        self._driver.start()
        self._pump_task = self._loop.create_task(self._deferral_pump())
        if host is None:
            return None
        self._server = await asyncio.start_server(
            self._on_connection, host, port
        )
        return self._server.sockets[0].getsockname()[:2]

    async def stop(self) -> None:
        self._stopping = True
        if self._pump_task is not None:
            self._pump_task.cancel()
            try:
                await self._pump_task
            except asyncio.CancelledError:
                pass
            self._pump_task = None
        if self._driver is not None:
            self._inbox.put(("stop",))
            await asyncio.get_running_loop().run_in_executor(
                None, self._driver.join
            )
            self._driver = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self._driver_err is not None:
            raise RuntimeError(
                "frontend driver thread died"
            ) from self._driver_err

    def driver_alive(self) -> bool:
        """True while the driver thread runs (False before `start()`, after
        `stop()`, and once it has died: `stop()` then raises its error)."""
        return self._driver is not None and self._driver.is_alive()

    def stats(self) -> dict:
        out = dict(self._c_loop)
        out.update(self._c_drv)
        if self._sched is not None:
            out["sched_enqueued_total"] = self._sched.enqueued_total
            out["sched_packed_total"] = self._sched.packed_total
            out["sched_ready"] = self._sched.ready()
        out["deferred_pending"] = len(self._deferred)
        out["lm_pending"] = len(self._pending_lm)
        return out

    # -- transport ----------------------------------------------------------

    async def _on_connection(self, reader, writer) -> None:
        def reply(payload: dict, _w=writer) -> None:
            # event-loop thread only; frames are small and the protocol
            # bounds in-flight replies by lm_queue_limit, so buffered
            # writes cannot grow without bound
            try:
                _w.write(encode_frame(
                    payload, max_frame_bytes=self.cfg.max_frame_bytes
                ))
            except (ConnectionResetError, RuntimeError):
                pass  # client went away; terminal accounting stands

        try:
            while True:
                msg = await read_frame(
                    reader, max_frame_bytes=self.cfg.max_frame_bytes
                )
                if msg is None:
                    break
                self.handle_message(msg, reply, transport="socket")
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    # -- message handling (event-loop thread) -------------------------------

    def handle_message(self, msg: dict,
                       reply: Callable[[dict], None],
                       transport: str = "inproc") -> None:
        """Single entry point for both transports."""
        kind = msg.get("type")
        if kind == "lm":
            self._handle_lm(msg, reply, transport)
        elif kind == "segment":
            self._handle_segment(msg, reply, transport)
        elif kind == "drain":
            self._handle_drain(reply)
        else:
            reply({"type": "error",
                   "detail": f"unknown message type {kind!r}"})

    def _bump(self, key: str, n: int = 1) -> None:
        self._c_loop[key] = self._c_loop.get(key, 0) + n

    def _finish_lm(self, uid, rid: str, reply, payload: dict) -> None:
        """The one terminal-reply point for LM requests: every accepted
        or shed request passes through here exactly once."""
        tel = obs.get()
        if tel.enabled:
            tel.tracer.instant(
                "frontend/reply", cat="frontend", request_id=rid,
                status=payload["status"],
                reason=payload.get("reason"),
            )
        if payload["status"] == STATUS_COMPLETED:
            self._bump("lm_completed")
        else:
            self._bump("lm_rejected")
            self._bump(f"lm_rejected_{payload['reason']}")
        if tel.enabled:
            # disabled registry drops counts anyway — guarding skips
            # the f-string format on the disabled path
            tel.registry.counter(
                f"frontend.lm_{payload['status']}_total"
            ).inc()
        reply({"type": "lm_result", "uid": uid, **payload})

    def _handle_lm(self, msg, reply, transport) -> None:
        tel = obs.get()
        self._bump("lm_received")
        uid = msg.get("uid")
        try:
            uid = int(uid)
            prompt = [int(t) for t in msg["prompt"]]
            max_new = int(msg.get("max_new", 16))
            eos = msg.get("eos")
            eos = None if eos is None else int(eos)
        except (KeyError, TypeError, ValueError) as e:
            self._finish_lm(uid, serve_rid(uid), reply, {
                "status": STATUS_REJECTED, "reason": REASON_INVALID,
                "detail": f"malformed lm request: {e}",
            })
            return
        rid = serve_rid(uid)
        if tel.enabled:
            tel.tracer.instant(
                "frontend/ingress", cat="frontend", request_id=rid,
                transport=transport, kind="lm",
                prompt_len=len(prompt),
            )
        if self.engine is None:
            self._finish_lm(uid, rid, reply, {
                "status": STATUS_REJECTED, "reason": REASON_INVALID,
                "detail": "this frontend serves no LM engine",
            })
            return
        if uid in self._pending_lm:
            self._finish_lm(uid, rid, reply, {
                "status": STATUS_REJECTED, "reason": REASON_INVALID,
                "detail": f"uid {uid} already pending on this frontend",
            })
            return
        # active admission control: shed, with an explicit typed
        # rejection, the moment offered load exceeds the configured
        # saturation rate — a shed request costs the engine nothing
        if self._lm_bucket is not None and not self._lm_bucket.try_take():
            self._finish_lm(uid, rid, reply, {
                "status": STATUS_REJECTED, "reason": REASON_ADMISSION,
                "detail": (
                    f"offered load exceeds the admission rate "
                    f"({self.cfg.admission_rate_rps:.3g} req/s, burst "
                    f"{self.cfg.admission_burst:.3g}); retry later"
                ),
            })
            return
        if len(self._pending_lm) >= self.cfg.lm_queue_limit:
            self._finish_lm(uid, rid, reply, {
                "status": STATUS_REJECTED, "reason": REASON_QUEUE_FULL,
                "detail": (
                    f"{self.cfg.lm_queue_limit} requests already "
                    f"pending (bounded ingress queue)"
                ),
            })
            return
        self._pending_lm[uid] = reply
        self._bump("lm_admitted")
        self._inbox.put(("lm", uid, prompt, max_new, eos))

    def _handle_segment(self, msg, reply, transport) -> None:
        tel = obs.get()
        self._bump("seg_received")
        try:
            patient = int(msg["patient"])
            seq = int(msg["seq"])
            deadline_rel = float(
                msg.get("deadline_rel_s", self.cfg.seg_deadline_rel_s)
            )
            urgent = bool(msg.get("urgent", False))
            if self._sched is None:
                raise ValueError("this frontend serves no stream fleet")
            if not 0 <= patient < self.n_patients:
                raise ValueError(
                    f"patient {patient} outside fleet of "
                    f"{self.n_patients}"
                )
        except (KeyError, TypeError, ValueError) as e:
            reply({"type": "segment_ack",
                   "patient": msg.get("patient"),
                   "seq": msg.get("seq"),
                   "status": STATUS_REJECTED,
                   "reason": REASON_INVALID, "detail": str(e)})
            self._bump("seg_rejected_invalid")
            return
        rid = stream_rid(patient, seq)
        if tel.enabled:
            tel.tracer.instant(
                "frontend/ingress", cat="frontend", request_id=rid,
                transport=transport, kind="segment", urgent=urgent,
            )
        ack = {"type": "segment_ack", "patient": patient, "seq": seq,
               "urgent": urgent}
        if urgent:
            # URGENT always passes — no bucket, no deferral — and
            # pins its patient's priority class
            self._bump("seg_urgent")
            self._client_urgent[patient] = True
            self._inbox.put(("segment", patient, seq, deadline_rel,
                             True))
            ack["status"] = "enqueued"
        elif (self._seg_bucket is None
              or self._seg_bucket.try_take()):
            self._inbox.put(("segment", patient, seq, deadline_rel,
                             False))
            self._bump("seg_enqueued")
            ack["status"] = "enqueued"
        else:
            # over-rate ROUTINE traffic is deferred, never dropped:
            # parked here and released as the bucket refills (or
            # immediately at drain)
            self._deferred.append((patient, seq, deadline_rel))
            self._bump("seg_deferred")
            ack["status"] = "deferred"
        if tel.enabled:
            # named ack, not reply: the ack precedes the segment's
            # stream hops in wall time, so it must not look like an
            # exit hop to `lineage.critical_path`
            tel.tracer.instant(
                "frontend/ack", cat="frontend", request_id=rid,
                status=ack["status"],
            )
        if tel.enabled:
            # as above: skip the f-string on the disabled path
            tel.registry.counter(
                f"frontend.seg_{ack['status']}_total"
            ).inc()
        reply(ack)

    def _handle_drain(self, reply) -> None:
        self._release_deferred(force=True)

        def resolve() -> None:
            reply({"type": "drained", "stats": self.stats()})

        self._inbox.put(("drain", resolve))

    def _release_deferred(self, *, force: bool) -> None:
        released = 0
        while self._deferred and (
            force or self._seg_bucket is None
            or self._seg_bucket.try_take()
        ):
            patient, seq, deadline_rel = self._deferred.pop(0)
            self._inbox.put(("segment", patient, seq, deadline_rel,
                             False))
            released += 1
        if released:
            self._bump("seg_deferred_released", released)

    async def _deferral_pump(self) -> None:
        while not self._stopping:
            if self._deferred:
                self._release_deferred(force=False)
            await asyncio.sleep(self.cfg.deferral_poll_s)

    # -- driver thread: the ONLY thread that touches the engines ------------

    def _post(self, cb: Callable, *args) -> None:
        self._loop.call_soon_threadsafe(cb, *args)

    def _resolve_lm(self, uid: int, payload: dict) -> None:
        # event-loop thread (posted from the driver)
        reply = self._pending_lm.pop(uid, None)
        if reply is not None:
            self._finish_lm(uid, serve_rid(uid), reply, payload)

    def _now(self) -> float:
        return self._clock() - self._epoch

    def _drive(self) -> None:
        try:
            if self._card is not None:  # a mesh's collectives run here
                torch.cuda.set_device(self._card)
            # grad mode is per thread: this one records no autograd graph
            with torch.no_grad():
                self._drive_inner()
        except BaseException as e:  # surfaced by stop()
            self._driver_err = e

    def _bump_drv(self, key: str) -> None:
        self._c_drv[key] = self._c_drv.get(key, 0) + 1

    def _send(self, record: dict) -> None:
        """Rank 0: a record to the other ranks, before acting on it."""
        if self._records is not None:
            self._records.send(record)
            self._bump_drv("records")
            self._sent_at = self._clock()

    def _submit(self, uid, prompt, max_new, eos):
        """`engine.submit` of one request: (the Request, None), or (None,
        its typed rejection) where the engine refused it."""
        from repro_torch.serve.engine import Request
        from repro_torch.serve.paging import PagesExhaustedError

        try:
            req = Request(uid=uid,
                          prompt=torch.tensor(prompt, dtype=torch.long),
                          max_new=max_new, eos=eos)
            self.engine.submit(req)
        except PagesExhaustedError as e:
            # never satisfiable on this page pool: the worst-case page
            # need exceeds the pool's whole usable pages, so queueing
            # could only stall — typed rejection clients can size down
            # from
            return None, {"status": STATUS_REJECTED, "reason": REASON_PAGES,
                          "detail": str(e)}
        except Exception as e:
            # engine-boundary validation (empty prompt, max_new <= 0,
            # duplicate in-flight uid) comes back as an explicit typed
            # rejection
            return None, {"status": STATUS_REJECTED,
                          "reason": REASON_INVALID, "detail": str(e)}
        return req, None

    def follow(self, records) -> None:
        """The other ranks of a mesh: replay rank 0's driver records
        (`records.recv()`) — each one's submits, tick and classify, the
        same engine calls in the same order — until its stop record. Call
        after `warm()`, in place of `start()`; replies nothing."""
        with torch.no_grad():
            while True:
                rec = records.recv()
                if rec.get("stop"):
                    return
                for item in rec.get("submit", ()):
                    self._submit(*item)  # a refusal falls as on rank 0
                if rec.get("tick"):
                    self.engine.tick()
                if rec.get("flush") is not None:
                    sigs = self._source.signals(*rec["flush"])
                    self._runner.classify(sigs["signal"])

    def _drive_inner(self) -> None:
        inflight: dict[int, Any] = {}
        drains: list[Callable] = []
        self._sent_at = self._clock()
        while True:
            progressed = False
            drained_inbox_dry = True
            submitted = []
            while True:
                try:
                    item = self._inbox.get_nowait()
                except queue.Empty:
                    break
                progressed = True
                kind = item[0]
                if kind == "stop":
                    self._send({"stop": True})
                    return
                if kind == "lm":
                    submitted.append(item[1:])
                    req, refused = self._submit(*item[1:])
                    if refused is not None:
                        self._post(self._resolve_lm, item[1], refused)
                    else:
                        inflight[item[1]] = req
                elif kind == "segment":
                    self._enqueue_segment(*item[1:])
                elif kind == "drain":
                    drains.append(item[1])
                    drained_inbox_dry = False
            tick = self.engine is not None and bool(
                inflight or self.engine._queue)
            if submitted or tick:
                self._send({"submit": submitted, "tick": tick})
            if tick:
                self.engine.tick()
                self._bump_drv("ticks")
                done = [u for u, r in inflight.items() if r.done]
                for uid in done:
                    req = inflight.pop(uid)
                    self._post(self._resolve_lm, uid, {
                        "status": STATUS_COMPLETED,
                        "tokens": [int(t) for t in req.output],
                    })
                progressed = True
            if self._sched is not None and self._sched.ready():
                if drains or self._sched.should_flush(self._now()):
                    self._flush_stream()
                    progressed = True
            if drains and drained_inbox_dry and not inflight and (
                self.engine is None or not self.engine._queue
            ) and (self._sched is None or not self._sched.ready()):
                for resolve in drains:
                    self._post(resolve)
                drains = []
            if not progressed:
                if (self._records is not None
                        and self._clock() - self._sent_at >= HEARTBEAT_S):
                    self._send({})  # a follower's receive stays in time
                time.sleep(self.cfg.idle_poll_s)

    def _enqueue_segment(self, patient, seq, deadline_rel,
                         urgent) -> None:
        from repro_torch.stream.sources import SegmentRef

        now = self._now()
        if urgent:
            self._sched.mark_urgent([patient])
        self._sched.enqueue(SegmentRef(
            patient=patient, seq=seq, arrival_s=now,
            deadline_s=now + deadline_rel,
        ))

    def _flush_stream(self) -> None:
        tel = obs.get()
        now = self._now()
        batch = self._sched.next_batch(now)
        if batch is None:
            return
        self._c_drv["seg_flushed"] = (
            self._c_drv.get("seg_flushed", 0) + batch.n_valid
        )
        self._c_drv["batches"] = self._c_drv.get("batches", 0) + 1
        if self._runner is None:
            return
        from repro_torch.stream import vote

        tagged = (
            {"request_ids": batch.request_ids}
            if batch.request_ids is not None else {}
        )
        self._send({"flush": (batch.patients, batch.seqs)})
        with tel.span("stream/flush", cat="stream",
                      bucket=batch.bucket, n_valid=batch.n_valid,
                      **tagged):
            sigs = self._source.signals(batch.patients, batch.seqs)
            with tel.span("stream/classify", cat="stream",
                          bucket=batch.bucket, **tagged):
                preds = self._runner.classify(sigs["signal"])
                tel.block(preds)
            with tel.span("stream/vote", cat="stream", **tagged):
                self._vstate, _emit, _diag, urgent = vote.update(
                    self._vstate,
                    batch.patients,
                    preds,
                    batch.valid,
                )
                tel.block(urgent)
        # vote-driven urgency never un-marks a client-pinned patient
        # (dtype pinned: an empty vote result must stay a bool mask,
        # never decay to float64 — the mark_urgent([]) class)
        self._sched.set_urgent(
            np.asarray(urgent.cpu(), bool) | self._client_urgent
        )


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------


class InProcClient:
    """Same handler, no socket: what the property tests and the
    in-process leg of the transport-delta benchmark drive. Futures
    resolve with the reply payload, stamped with `_t_recv`."""

    def __init__(self, frontend: Frontend):
        self._fe = frontend

    def _future_reply(self):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()

        def reply(payload: dict) -> None:
            if not fut.done():
                payload = dict(payload)
                payload["_t_recv"] = time.perf_counter()
                fut.set_result(payload)

        return fut, reply

    async def send_lm(self, uid: int, prompt, max_new: int = 16,
                      eos=None) -> asyncio.Future:
        fut, reply = self._future_reply()
        self._fe.handle_message(
            {"type": "lm", "uid": uid, "prompt": list(prompt),
             "max_new": max_new, "eos": eos},
            reply, transport="inproc",
        )
        return fut

    async def send_segment(self, patient: int, seq: int, *,
                           deadline_rel_s: Optional[float] = None,
                           urgent: bool = False) -> asyncio.Future:
        fut, reply = self._future_reply()
        msg = {"type": "segment", "patient": patient, "seq": seq,
               "urgent": urgent}
        if deadline_rel_s is not None:
            msg["deadline_rel_s"] = deadline_rel_s
        self._fe.handle_message(msg, reply, transport="inproc")
        return fut

    async def drain(self, timeout: float = 120.0) -> dict:
        fut, reply = self._future_reply()
        self._fe.handle_message({"type": "drain"}, reply)
        return await asyncio.wait_for(fut, timeout)

    async def close(self) -> None:
        pass


class SocketClient:
    """Length-prefixed JSON over TCP; request ids are minted here, on
    the client, and the server carries them through every hop."""

    def __init__(self, reader, writer):
        self._reader = reader
        self._writer = writer
        self._lm: dict[int, asyncio.Future] = {}
        self._seg: dict[tuple, asyncio.Future] = {}
        self._drains: list[asyncio.Future] = []
        self._task = asyncio.get_running_loop().create_task(
            self._read_loop()
        )

    @classmethod
    async def connect(cls, host: str, port: int) -> "SocketClient":
        reader, writer = await asyncio.open_connection(host, port)
        return cls(reader, writer)

    async def _read_loop(self) -> None:
        try:
            while True:
                msg = await read_frame(self._reader)
                if msg is None:
                    break
                msg["_t_recv"] = time.perf_counter()
                kind = msg.get("type")
                fut = None
                if kind == "lm_result":
                    fut = self._lm.pop(msg.get("uid"), None)
                elif kind == "segment_ack":
                    fut = self._seg.pop(
                        (msg.get("patient"), msg.get("seq")), None
                    )
                elif kind == "drained" and self._drains:
                    fut = self._drains.pop(0)
                if fut is not None and not fut.done():
                    fut.set_result(msg)
        except asyncio.CancelledError:
            pass

    async def _send(self, msg: dict) -> None:
        self._writer.write(encode_frame(msg))
        # awaiting drain() propagates TCP backpressure to the caller
        await self._writer.drain()

    async def send_lm(self, uid: int, prompt, max_new: int = 16,
                      eos=None) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        self._lm[uid] = fut
        await self._send({"type": "lm", "uid": uid,
                          "prompt": list(prompt),
                          "max_new": max_new, "eos": eos})
        return fut

    async def send_segment(self, patient: int, seq: int, *,
                           deadline_rel_s: Optional[float] = None,
                           urgent: bool = False) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        self._seg[(patient, seq)] = fut
        msg = {"type": "segment", "patient": patient, "seq": seq,
               "urgent": urgent}
        if deadline_rel_s is not None:
            msg["deadline_rel_s"] = deadline_rel_s
        await self._send(msg)
        return fut

    async def drain(self, timeout: float = 120.0) -> dict:
        fut = asyncio.get_running_loop().create_future()
        self._drains.append(fut)
        await self._send({"type": "drain"})
        return await asyncio.wait_for(fut, timeout)

    async def close(self) -> None:
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass
        self._writer.close()
        try:
            await self._writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass


__all__ = [
    "Frontend",
    "FrontendConfig",
    "InProcClient",
    "RankRecords",
    "SocketClient",
    "TokenBucket",
    "encode_frame",
    "read_frame",
    "REASON_ADMISSION",
    "REASON_INVALID",
    "REASON_PAGES",
    "REASON_QUEUE_FULL",
    "STATUS_COMPLETED",
    "STATUS_REJECTED",
]

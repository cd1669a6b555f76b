"""PyTorch port vs JAX package on the async serving frontend
(tests/test_frontend.py's six tests, ported), its first load-lab piece,
and the entry points that reach it: `launch.serve --listen/--connect`
(with the paged cache and chunked prefill) and `launch.stream` (default,
`--listen`, `--connect`) on the CPU.

The LM replies of the port's frontend are held equal to the reference
frontend's on the same numpy weights (reduced qwen3-8b in float32) and
prompts: the same statuses, rejection reasons and tokens, over the
in-process transport and over a loopback socket. The stream side's
segment content comes from the port's own synthesizer (the port cannot
reproduce threefry), so it is held to the reference's accounting
contract: every segment acked, enqueued == packed after a drain.
"""

import asyncio
import os
import queue
import signal
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_bridge import CPU, np_tokens, shared_lm_models
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.obs import loadlab as jloadlab
from repro.serve import engine as jE
from repro.serve import frontend as jfe
from repro.serve import paging as jpaging
from repro_torch import obs
from repro_torch.core import compiler, vadetect
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import stream as tstream
from repro_torch.obs import lineage
from repro_torch.obs import loadlab as tloadlab
from repro_torch.serve import engine as tE
from repro_torch.serve import frontend as tfe
from repro_torch.serve import paging as tpaging
from repro_torch.stream import FleetRunner

REPO = Path(__file__).resolve().parents[1]
PROMPT_LEN = 4
MAX_NEW = 3
MAX_SEQ = PROMPT_LEN + MAX_NEW + 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread, so that the
    suite's parallel workers do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def built():
    """Both packages' reduced qwen3-8b on the same weights; makers of a
    fresh engine each (the reference's on shared jitted cells)."""
    mj, mt, pj, pt = shared_lm_models("qwen3_8b", "float32", max_seq=MAX_SEQ)

    def make(pkg, **kw):
        if pkg == "port":
            return tE.Engine(mt, pt, batch_size=2, device=CPU, **kw)
        return jE.Engine(mj, pj, batch_size=2, **kw)

    def prompts(count, length=PROMPT_LEN):
        return [np_tokens((length,), mt.cfg.vocab, 50 + i).tolist()
                for i in range(count)]

    return make, prompts


def _terminal(replies):
    """What the two packages must agree on, reply by reply."""
    return [(r["uid"], r["status"], r.get("reason"), r.get("tokens"))
            for r in replies]


# -- wire framing -----------------------------------------------------------


def test_frame_roundtrip():
    """Frames read back as sent, a clean EOF at a frame boundary reads as
    None, and the bytes on the wire are the reference's."""
    msg = {"type": "lm", "uid": 3, "prompt": [1, 2],
           "nested": {"a": [1.5, None, "x"]}}
    assert tfe.encode_frame(msg) == jfe.encode_frame(msg)

    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(tfe.encode_frame(msg)
                         + tfe.encode_frame({"type": "drain"}))
        reader.feed_eof()
        return (await tfe.read_frame(reader), await tfe.read_frame(reader),
                await tfe.read_frame(reader))

    assert asyncio.run(go()) == (msg, {"type": "drain"}, None)


def test_frame_size_cap():
    with pytest.raises(ValueError, match="exceeds"):
        tfe.encode_frame({"x": "a" * 100}, max_frame_bytes=16)

    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(tfe.encode_frame({"x": "a" * 100}))
        return await tfe.read_frame(reader, max_frame_bytes=16)

    with pytest.raises(ValueError, match="exceeds"):
        asyncio.run(go())


# -- token bucket -----------------------------------------------------------


def test_token_bucket_burst_exact():
    """Back-to-back offers against a full bucket admit exactly
    floor(burst); refill is rate * elapsed, clamped at burst — offer for
    offer the reference bucket's decisions on the same clock."""
    clock = [0.0]
    tb = tfe.TokenBucket(2.0, 3.0, clock=lambda: clock[0])
    jb = jfe.TokenBucket(2.0, 3.0, clock=lambda: clock[0])
    got = []
    for dt, offers in ((0.0, 5), (1.0, 3), (100.0, 4), (0.25, 2)):
        clock[0] += dt
        got.append([(tb.try_take(), jb.try_take()) for _ in range(offers)])
    for row in got:
        assert all(a == b for a, b in row)
    assert [a for a, _ in got[0]] == [True] * 3 + [False] * 2
    assert [a for a, _ in got[1]] == [True, True, False]
    assert [a for a, _ in got[2]] == [True] * 3 + [False]


def test_token_bucket_validates():
    with pytest.raises(ValueError):
        tfe.TokenBucket(0.0, 4.0)
    with pytest.raises(ValueError):
        tfe.TokenBucket(1.0, 0.5)


# -- shedding contract (property, in-process transport) ---------------------


async def _inproc_run(fe, prompts, *, urgent=3, routine=(1, 2, 3)):
    """LM requests, URGENT and ROUTINE segments through an InProcClient,
    then a drain. Works for either package's Frontend."""
    mod = tfe if isinstance(fe, tfe.Frontend) else jfe
    await fe.start(host=None)
    client = mod.InProcClient(fe)
    futs = [await client.send_lm(uid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    ufuts = [await client.send_segment(patient=0, seq=s, urgent=True)
             for s in range(urgent)]
    rfuts = [await client.send_segment(patient=p, seq=0) for p in routine]
    res = [await asyncio.wait_for(f, 60.0) for f in futs]
    uacks = [await asyncio.wait_for(f, 60.0) for f in ufuts]
    racks = [await asyncio.wait_for(f, 60.0) for f in rfuts]
    stats = (await client.drain())["stats"]
    await fe.stop()
    return res, uacks, racks, stats


@settings(max_examples=4, deadline=None)
@given(
    n_lm=st.integers(min_value=4, max_value=10),
    burst=st.integers(min_value=1, max_value=4),
    gated=st.booleans(),
)
def test_inproc_shedding_property(built, n_lm, burst, gated):
    """For any offered burst: exactly one terminal outcome per LM
    request; with an admission rate (near-zero refill, integer burst b)
    exactly min(n, b) complete and the rest carry the typed
    `admission_rate` rejection; with no rate nothing is rejected; URGENT
    segments are enqueued at any load while over-rate ROUTINE ones defer,
    never drop. Every LM reply equals the reference frontend's."""
    make, prompts = built
    kw = dict(admission_rate_rps=(1e-9 if gated else None),
              admission_burst=float(burst),
              stream_rate_rps=(1e-9 if gated else None), stream_burst=1.0)
    runs = {}
    for pkg, mod in (("port", tfe), ("ref", jfe)):
        fe = mod.Frontend(engine=make(pkg), n_patients=4,
                          cfg=mod.FrontendConfig(**kw))
        fe.warm(PROMPT_LEN)
        runs[pkg] = asyncio.run(_inproc_run(fe, prompts(n_lm)))
    res, uacks, racks, stats = runs["port"]
    assert _terminal(res) == _terminal(runs["ref"][0])
    completed = [r for r in res if r["status"] == "completed"]
    rejected = [r for r in res if r["status"] == "rejected"]
    assert len(completed) + len(rejected) == n_lm
    for r in completed:
        assert len(r["tokens"]) == MAX_NEW and "reason" not in r
    for r in rejected:
        assert r["reason"] == "admission_rate" and "tokens" not in r
    assert stats.get("lm_completed", 0) == len(completed)
    assert stats.get("lm_rejected", 0) == len(rejected)
    assert len(completed) == (min(n_lm, burst) if gated else n_lm)
    assert all(a["status"] == "enqueued" for a in uacks)
    assert [a["status"] for a in racks] == \
        [a["status"] for a in runs["ref"][2]]
    if gated:
        assert sum(a["status"] == "deferred" for a in racks) == 2
    assert stats["deferred_pending"] == 0
    assert stats["sched_enqueued_total"] == stats["sched_packed_total"] \
        == len(uacks) + len(racks)


# -- loopback socket end-to-end ---------------------------------------------


def test_socket_loopback_lineage(built):
    """Client-minted request ids survive the wire: a completed LM request
    and a streamed segment sent over a real loopback socket each join a
    lineage of >= 4 distinct hops including the transport's. The LM
    reply's tokens equal the reference frontend's over its socket."""
    make, prompts = built

    async def go(mod, fe):
        host, port = await fe.start("127.0.0.1", 0)
        client = await mod.SocketClient.connect(host, port)
        f1 = await client.send_lm(uid=0, prompt=prompts(1)[0],
                                  max_new=MAX_NEW)
        f2 = await client.send_segment(patient=1, seq=0)
        r1 = await asyncio.wait_for(f1, 60.0)
        a1 = await asyncio.wait_for(f2, 60.0)
        await client.drain()
        await client.close()
        await fe.stop()
        return r1, a1

    jf = jfe.Frontend(engine=make("ref"), n_patients=2,
                      cfg=jfe.FrontendConfig())
    jf.warm(PROMPT_LEN)
    r_ref, _ = asyncio.run(go(jfe, jf))
    fe = tfe.Frontend(engine=make("port"), n_patients=2,
                      cfg=tfe.FrontendConfig())
    fe.warm(PROMPT_LEN)  # outside the trace: warm uids aren't lineages
    tel = obs.configure(enabled=True)
    try:
        r1, a1 = asyncio.run(go(tfe, fe))
        events = tel.tracer.events()
    finally:
        obs.reset()
    assert r1["status"] == "completed" and len(r1["tokens"]) == MAX_NEW
    assert r1["tokens"] == r_ref["tokens"]
    assert a1["status"] == "enqueued"
    joined = lineage.assert_joined(events, min_hops=4)
    assert {"frontend/ingress", "serve/submit", "serve/finish",
            "frontend/reply"} <= {h.name for h in joined["serve:0"]}
    assert {"frontend/ingress", "frontend/ack", "stream/enqueue"} <= \
        {h.name for h in joined["stream:1:0"]}
    cp = lineage.critical_path(joined["serve:0"])
    assert cp["hop_names"][0] == "frontend/ingress"
    assert cp["hop_names"][-1] == "frontend/reply"
    assert cp["total_s"] > 0


# -- the paged and chunked engine behind the frontend -----------------------


def test_frontend_serves_the_paged_chunked_engine_like_the_reference(built):
    """A paged engine with chunked prefill behind the frontend: mixed
    prompt lengths (shorter and longer than a chunk) all complete with the
    reference frontend's tokens, and a request the page pool can never
    hold comes back as the typed `pages_exhausted` rejection in both."""
    make, _ = built
    # pages of 3 positions, 2 usable: prompt + max_new up to 6 fits, a
    # prompt of 7 never can
    lens = (2, 5, 4, 3)
    ps = [np_tokens((s,), 512, 70 + i).tolist() for i, s in enumerate(lens)]
    too_long = np_tokens((7,), 512, 99).tolist()
    replies = {}
    for pkg, mod, pg in (("port", tfe, tpaging), ("ref", jfe, jpaging)):
        fe = mod.Frontend(engine=make(pkg, paging=pg.PagingConfig(3, 3),
                                      chunk_tokens=3),
                          cfg=mod.FrontendConfig())

        async def go(fe=fe, mod=mod):
            await fe.start(host=None)
            client = mod.InProcClient(fe)
            futs = [await client.send_lm(uid=i, prompt=p, max_new=2)
                    for i, p in enumerate(ps)]
            futs.append(await client.send_lm(uid=9, prompt=too_long,
                                             max_new=2))
            out = [await asyncio.wait_for(f, 60.0) for f in futs]
            await fe.stop()
            return out

        replies[pkg] = asyncio.run(go())
    assert _terminal(replies["port"]) == _terminal(replies["ref"])
    assert [r["status"] for r in replies["port"]] == \
        ["completed"] * 4 + ["rejected"]
    assert replies["port"][-1]["reason"] == "pages_exhausted"


def test_driver_thread_error_surfaces_from_stop(built):
    """An exception on the driver thread is not swallowed: the driver
    stops, `driver_alive()` says so, and `stop()` raises it."""
    make, prompts = built
    eng = make("port")

    def broken_tick():
        raise RuntimeError("tick failed")

    eng.tick = broken_tick
    fe = tfe.Frontend(engine=eng, cfg=tfe.FrontendConfig())

    async def go():
        await fe.start(host=None)
        client = tfe.InProcClient(fe)
        await client.send_lm(uid=0, prompt=prompts(1)[0], max_new=2)
        for _ in range(500):
            if not fe.driver_alive():
                break
            await asyncio.sleep(0.01)
        assert not fe.driver_alive()
        await fe.stop()

    with pytest.raises(RuntimeError, match="driver thread died") as ei:
        asyncio.run(go())
    assert "tick failed" in str(ei.value.__cause__)


def test_stream_side_classifies_on_the_kernel_path():
    """A stream-only frontend with a kernel-path FleetRunner: every
    segment is acked and packed, each flush classifies one bucket, and the
    vote machines count every flushed segment."""
    program = compiler.compile_model(
        vadetect.init(torch.Generator().manual_seed(0), device=CPU))
    runner = FleetRunner(program, path="kernel", device=CPU)
    fe = tfe.Frontend(n_patients=6, runner=runner,
                      cfg=tfe.FrontendConfig(stream_buckets=(4, 8)))
    fe.warm()
    assert runner.jit_cache_misses() == 2

    async def go():
        await fe.start(host=None)
        client = tfe.InProcClient(fe)
        futs = [await client.send_segment(patient=p, seq=s,
                                          urgent=(p == 0))
                for s in range(3) for p in range(6)]
        acks = [await asyncio.wait_for(f, 60.0) for f in futs]
        stats = (await client.drain())["stats"]
        await fe.stop()
        return acks, stats

    acks, stats = asyncio.run(go())
    assert all(a["status"] == "enqueued" for a in acks)
    assert stats["sched_enqueued_total"] == stats["sched_packed_total"] == 18
    assert stats["seg_flushed"] == 18 and stats["batches"] >= 3
    assert int(fe._vstate.count.sum()) == 18
    assert runner.jit_cache_misses() == 2  # flushes only hit declared buckets


# -- the load lab's first piece ---------------------------------------------


def test_arrival_schedules_are_seeded_and_shaped_like_the_reference():
    """Poisson gaps: deterministic in (seed, uid), independent across
    uids, mean 1/rate. Trace gaps: the reference's normalized template,
    cyclically shifted by a seeded offset (the reference's own schedule
    is a rotation of the same sequence). Validation errors match."""
    a = tloadlab.arrival_times(3, 0, rate_hz=50.0, n=4000)
    assert np.array_equal(a, tloadlab.arrival_times(3, 0, rate_hz=50.0,
                                                    n=4000))
    assert not np.array_equal(a, tloadlab.arrival_times(3, 1, rate_hz=50.0,
                                                        n=4000))
    assert np.all(np.diff(a) > 0)
    gaps = np.diff(np.concatenate([[0.0], a]))
    assert abs(gaps.mean() * 50.0 - 1.0) < 0.05
    tpl = len(tloadlab.DEFAULT_TRACE_TEMPLATE)
    got = tloadlab.interarrival_gaps(3, 0, rate_hz=2.0, n=2 * tpl,
                                     process="trace")
    want = jloadlab.interarrival_gaps(jax.random.PRNGKey(3), 0, rate_hz=2.0,
                                      n=2 * tpl, process="trace")
    assert any(np.allclose(np.roll(want, k), got) for k in range(tpl))
    assert tloadlab.ARRIVAL_PROCESSES == jloadlab.ARRIVAL_PROCESSES
    for kw in ({"rate_hz": 0.0, "n": 3}, {"rate_hz": 1.0, "n": 0},
               {"rate_hz": 1.0, "n": 3, "process": "nope"},
               {"rate_hz": 1.0, "n": 3, "process": "trace",
                "template": (1.0, -1.0)}):
        with pytest.raises(ValueError):
            tloadlab.interarrival_gaps(0, 0, **kw)
        with pytest.raises(ValueError):
            jloadlab.interarrival_gaps(jax.random.PRNGKey(0), 0, **kw)


def test_warm_engine_leaves_a_paged_chunked_engine_idle(built):
    """`warm_engine` runs one admission group of the pool's width (the
    prompts cut to the chunk width), the pool decode and one prompt
    through the chunk cell, then leaves no request, page or chunk
    behind."""
    make, _ = built
    eng = make("port", paging=tpaging.PagingConfig(3, 7), chunk_tokens=2)
    tloadlab.warm_engine(eng, 5)
    assert eng.batch == 2
    assert eng.admission_prefills == 1  # both 2-token prompts, one group
    assert eng.admission_rowsteps == 2 * 2 + 5  # and the chunked one
    assert not eng._queue and not eng._chunks and not eng._inflight
    assert all(s is None for s in eng._slots)
    assert eng._pg.allocated_pages() == 0 and eng.cache_bytes_in_use() == 0


# -- the entry points on the CPU --------------------------------------------


def _start_server(code: str):
    """Run `code` in a fresh interpreter (a server that prints its bound
    address); returns (process, address, its output lines so far)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    seen = []
    while True:
        try:
            ln = lines.get(timeout=120)
        except queue.Empty:
            proc.kill()
            raise AssertionError(f"no listening line: {seen}")
        seen.append(ln)
        if "listening on" in ln:
            return proc, ln.split("listening on ")[1].split()[0], lines, seen


def _stop_server(proc, lines, seen) -> list:
    proc.send_signal(signal.SIGINT)
    rc = proc.wait(timeout=60)
    while not lines.empty():
        seen.append(lines.get())
    assert rc == 0, "".join(seen)
    return seen


def test_launch_serve_listen_and_connect_over_loopback():
    """`launch.serve --listen` (reduced qwen3-8b, paged with chunked
    prefill) in one process and `--connect` in this one: every request
    completes, with the tokens the same build's engine gives the same
    prompts directly; SIGINT stops the server cleanly."""
    argv = ["--arch", "qwen3-8b", "--reduced", "--batch", "2",
            "--prompt-len", "6", "--max-new", "4"]
    code = ("from repro_torch.launch import serve\n"
            f"serve.main({argv + ['--listen', '127.0.0.1:0', '--page-size', '4', '--chunk-tokens', '4']!r}, device='cpu')\n")
    proc, addr, lines, seen = _start_server(code)
    try:
        rec = tlaunch.main(argv + ["--connect", addr, "--load-requests", "5",
                                   "--offered-rate", "50"], device="cpu")
    finally:
        seen = _stop_server(proc, lines, seen)
    assert any(ln.startswith("[serve] frontend stopped: {") for ln in seen)
    assert rec["completed"] == 5 and rec["rejected"] == 0
    args = tlaunch.main.__globals__["argparse"].Namespace(
        arch="qwen3-8b", reduced=True, batch=2, prompt_len=6, max_new=4,
        seed=0, page_size=4, pages_per_device=None, chunk_tokens=4)
    _, make_engine = tlaunch._build_lm_engine(args, device="cpu")
    eng = make_engine()
    assert eng.model.max_seq == 12 and eng.paging.n_pages == 2 * 3 + 1
    for r in rec["results"]:
        rng = np.random.default_rng(np.random.SeedSequence([0, 100 + r["uid"]]))
        req = tE.Request(uid=r["uid"], prompt=torch.from_numpy(
            rng.integers(0, 512, 6)), max_new=4)
        eng.submit(req)
        eng.run(max_ticks=40)
        assert r["tokens"] == req.output, r["uid"]


def test_launch_serve_listen_flag_errors():
    for argv in (["--arch", "qwen3-8b", "--reduced", "--pages-per-device",
                  "5"],
                 ["--arch", "va-cnn", "--listen", "127.0.0.1:0"]):
        with pytest.raises(SystemExit):
            tlaunch.main(argv, device="cpu")


def test_launch_stream_default_listen_and_connect():
    """`launch.stream`'s default path (the fleet simulation on the kernel
    path), then `--listen` in one process and `--connect` in this one:
    every segment acked, the drained scheduler packed all it enqueued."""
    out = tstream.main(["--patients", "12", "--segments", "6",
                        "--path", "kernel", "--buckets", "8,32"],
                       device="cpu")
    m = out["metrics"]
    assert m["segments_total"] == 72 and m["dropped_total"] == 0
    assert out["jit_cache_misses"] == 2
    code = ("from repro_torch.launch import stream\n"
            "stream.main(['--listen', '127.0.0.1:0', '--path', 'kernel', "
            "'--patients', '12', '--buckets', '8,32'], device='cpu')\n")
    proc, addr, lines, seen = _start_server(code)
    try:
        rec = tstream.main(["--connect", addr, "--patients", "12",
                            "--segments", "4", "--offered-rate", "400"],
                           device="cpu")
    finally:
        _stop_server(proc, lines, seen)
    assert rec["acked"] == 48 and sum(rec["acks"].values()) == 48
    assert rec["stats"]["sched_enqueued_total"] == \
        rec["stats"]["sched_packed_total"] == 48


@pytest.mark.parametrize("flag", sorted(tstream._NOT_PORTED))
def test_launch_stream_refuses_flags_not_ported(flag, capsys):
    argv = [flag] if flag in tstream._SWITCHES else [flag, "2"]
    with pytest.raises(SystemExit):
        tstream.main(argv, device="cpu")
    assert "ROADMAP.md queue 1 item 9" in capsys.readouterr().err


def test_launch_stream_listen_devices_reaches_the_spawn(monkeypatch):
    """`--listen --devices 2` (a frontend over a data mesh) parses and
    goes to `launch._spawn.run` with the listening rank function, as a
    run with no bound of the whole: a server ends on SIGINT
    (tests/test_torch_mesh_frontend.py serves one)."""
    calls = []
    monkeypatch.setattr(
        tstream._spawn, "run",
        lambda fn, world, **kw: calls.append((fn, world,
                                              kw.get("until_stopped"))))
    tstream.main(["--listen", "127.0.0.1:0", "--devices", "2"], device="cpu")
    assert calls == [(tstream._listen_rank, 2, True)]

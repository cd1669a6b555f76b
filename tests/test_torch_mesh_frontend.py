"""The serving frontend over a mesh: `launch.serve --listen --mesh` and
`launch.stream --listen --devices N` on the CPU, and the rank-0 driver's
records replayed by a follower.

A frontend over a mesh runs one process a rank: rank 0 owns the socket,
the admission and the stream scheduler, and sends each driver pass as a
record (`serve.frontend.RankRecords`); the other ranks replay the records
(`Frontend.follow`), so every rank makes the same engine calls. The
reference is one process over its devices and has no such layer, so
these hold the port against itself:

- the follower's replay, in process: the records of a leader serving
  requests (some refused by the engine) and stream buckets, replayed into
  a second engine and runner, give the leader's tokens, refusals and
  classified buckets exactly;
- `launch.serve --listen --mesh 2x2` (reduced qwen3-8b, the paged pool
  and chunked prefill) in a server subprocess over 4 gloo ranks, driven
  by `--connect` from the test: every request completes with the tokens
  the single-device engine gives the same prompts (reduced qwen3 keeps
  its greedy tokens at 2x2, tests/test_torch_sharded.py); SIGINT ends
  every rank with exit status 0; the SIGINT goes to the server's whole
  process group, as a terminal's Ctrl-C does, so rank 0 gets it twice;
- `launch.stream --listen --devices 4` (the kernel path's plain version)
  run through `main` on each rank of a 4-rank group in a server
  subprocess: every segment acked, enqueued == packed, and every bucket
  rank 0 classified equal to the single-device runner's predictions.

Each server has its own time limit. A spawned run's bound of the whole
(`launch._spawn.RUN_TIMEOUT_S`) is cut to 1 s in the servers: a server
ends on SIGINT, not at that bound.
"""

import asyncio
import os
import pickle
import queue
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import compiler, vadetect
from repro_torch.launch import _spawn
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import stream as tstream
from repro_torch.models import api
from repro_torch.serve import engine as tE
from repro_torch.serve import frontend as tfe
from repro_torch.serve import paging as tpaging
from repro_torch.stream import FleetRunner

REPO = Path(__file__).resolve().parents[1]
START_S = 90  # a server's spawn, build and warm-up, to its address line
STOP_S = 60  # SIGINT to exit
# a server's code starts with this: a spawned run's bound of the whole far
# shorter than the server lives
SHORT_RUN = ("from repro_torch.launch import _spawn\n"
             "_spawn.RUN_TIMEOUT_S = 1.0\n")


class _Wire:
    """A record channel in one process: `send` keeps each record as it
    would cross the wire (pickled), `recv` hands them back in order."""

    def __init__(self):
        self.records = []

    def send(self, record: dict) -> None:
        self.records.append(pickle.dumps(record))

    def recv(self) -> dict:
        return pickle.loads(self.records.pop(0))


def _engine(model, params):
    return tE.Engine(model, params, batch_size=2,
                     paging=tpaging.PagingConfig(3, 3), chunk_tokens=3,
                     device="cpu")


def test_follower_replays_the_leaders_lm_records(monkeypatch):
    """A leader serving requests (prompts shorter and longer than a chunk,
    an empty prompt, one its page pool can never hold) with a heartbeat
    while idle; its records replayed into a second engine: the same
    requests taken and refused, each taken one with the leader's tokens,
    and the stop record last."""
    cfg = configs.reduced("qwen3_8b")
    model = api.build_model(cfg, tp=1, max_seq=9)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (2, 5, 4, 3)]
    prompts += [[], rng.integers(0, cfg.vocab, 7).tolist()]
    wire = _Wire()
    monkeypatch.setattr(tfe, "HEARTBEAT_S", 0.02)
    lead = tfe.Frontend(engine=_engine(model, params), records=wire)

    async def go():
        await lead.start(host=None)
        client = tfe.InProcClient(lead)
        futs = [await client.send_lm(uid=i, prompt=p, max_new=2)
                for i, p in enumerate(prompts)]
        out = [await asyncio.wait_for(f, 60.0) for f in futs]
        await asyncio.sleep(0.2)  # idle: heartbeats
        await lead.stop()
        return out

    replies = asyncio.run(go())
    assert [r["status"] for r in replies] == ["completed"] * 4 + \
        ["rejected"] * 2
    assert [r["reason"] for r in replies[4:]] == ["invalid",
                                                  "pages_exhausted"]
    records = [pickle.loads(r) for r in wire.records]
    assert records[-1] == {"stop": True} and {} in records  # a heartbeat
    assert lead.stats()["records"] == len(records)

    follower_eng = _engine(model, params)
    taken = []
    submit = follower_eng.submit

    def record_submit(req):
        submit(req)
        taken.append(req)

    follower_eng.submit = record_submit
    tfe.Frontend(engine=follower_eng).follow(wire)
    assert not wire.records  # it stopped at the stop record
    assert [r.uid for r in taken] == [0, 1, 2, 3]
    assert all(r.done for r in taken)
    assert [r.output for r in taken] == [r["tokens"] for r in replies[:4]]


def test_follower_replays_the_leaders_stream_records():
    """A stream-only leader flushing buckets: the follower's runner
    classifies the same buckets (signals synthesized from the records'
    patients and seqs), with the leader's predictions."""
    program = compiler.compile_model(
        vadetect.init(torch.Generator().manual_seed(0), device="cpu"))

    def frontend(records=None):
        runner = FleetRunner(program, path="kernel", device="cpu",
                             record=True)
        return runner, tfe.Frontend(
            n_patients=6, runner=runner, records=records,
            cfg=tfe.FrontendConfig(stream_buckets=(4, 8)))

    wire = _Wire()
    lead_runner, lead = frontend(wire)

    async def go():
        await lead.start(host=None)
        client = tfe.InProcClient(lead)
        futs = [await client.send_segment(patient=p, seq=s, urgent=(p == 0))
                for s in range(3) for p in range(6)]
        acks = [await asyncio.wait_for(f, 60.0) for f in futs]
        stats = (await client.drain())["stats"]
        await lead.stop()
        return acks, stats

    acks, stats = asyncio.run(go())
    assert all(a["status"] == "enqueued" for a in acks)
    assert stats["sched_packed_total"] == 18
    follow_runner, follower = frontend()
    follower.follow(wire)
    assert len(follow_runner.recorded) == len(lead_runner.recorded) == \
        stats["batches"]
    for (x0, y0), (x1, y1) in zip(lead_runner.recorded,
                                  follow_runner.recorded):
        assert torch.equal(x0, x1) and torch.equal(y0, y1)


def test_launcher_forwards_one_sigint_and_raises_on_the_second():
    """The spawning launcher hands its first SIGINT to rank 0 (here a
    child standing for it) and raises on a second, so the ranks of a run
    that did not stop are killed."""
    code = ("import signal, sys, time\n"
            "signal.signal(signal.SIGINT, lambda *_: sys.exit(7))\n"
            "print('ready', flush=True)\n"
            "time.sleep(60)\n")
    lead = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    try:
        assert lead.stdout.readline() == "ready\n"
        restore = _spawn._forward_sigint(lead)
        try:
            signal.raise_signal(signal.SIGINT)
            assert lead.wait(timeout=30) == 7
            with pytest.raises(KeyboardInterrupt):
                signal.raise_signal(signal.SIGINT)
                time.sleep(1.0)  # the handler runs before this ends
        finally:
            restore()
    finally:
        lead.kill()
        lead.wait()


# -- the servers over a mesh -------------------------------------------------


def _children(pid: int) -> set:
    """The pids whose parent is `pid`."""
    out = set()
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        out.add(int(d))
            except (OSError, ValueError, IndexError):
                pass
    return out


def _start_server(code: str):
    """Run `code` in a fresh interpreter (a server that prints its bound
    address); returns (process, address, its output queue, lines so
    far)."""
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO / 'tests'}")
    proc = subprocess.Popen([sys.executable, "-c", SHORT_RUN + code],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    seen = []
    deadline = time.monotonic() + START_S
    while True:
        try:
            ln = lines.get(timeout=1.0)
        except queue.Empty:
            if proc.poll() is None and time.monotonic() < deadline:
                continue
            proc.kill()
            raise AssertionError(f"no listening line: {seen}")
        seen.append(ln)
        if "listening on" in ln:
            return proc, ln.split("listening on ")[1].split()[0], lines, seen


def _stop_server(proc, lines, seen, ranks: set, *, group=False) -> list:
    """SIGINT to the server (to its whole process group, as a terminal
    sends it, with `group`): exit status 0, and none of its rank
    processes left."""
    if group:
        os.killpg(proc.pid, signal.SIGINT)
    else:
        proc.send_signal(signal.SIGINT)
    try:
        rc = proc.wait(timeout=STOP_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    deadline = time.monotonic() + 5.0  # the last lines, the ranks' exit
    left = [p for p in ranks if os.path.exists(f"/proc/{p}")]
    while left and time.monotonic() < deadline:
        time.sleep(0.05)
        left = [p for p in ranks if os.path.exists(f"/proc/{p}")]
    time.sleep(0.2)
    while not lines.empty():
        seen.append(lines.get())
    assert rc == 0, "".join(seen)
    for p in left:  # not ours to leave behind
        os.kill(p, signal.SIGKILL)
    assert not left, left
    return seen


def _ranks_of(proc, n: int) -> set:
    """The server's rank processes (its children, polled until n)."""
    for _ in range(100):
        kids = _children(proc.pid)
        if len(kids) >= n:
            return kids
        time.sleep(0.05)
    return kids


def test_launch_serve_listen_mesh_2x2():
    argv = ["--arch", "qwen3-8b", "--reduced", "--batch", "4",
            "--prompt-len", "6", "--max-new", "4"]
    server = argv + ["--listen", "127.0.0.1:0", "--page-size", "4",
                     "--chunk-tokens", "4", "--mesh", "2x2"]
    code = ("from repro_torch.launch import serve\n"
            f"serve.main({server!r}, device='cpu')\n")
    proc, addr, lines, seen = _start_server(code)
    try:
        kids = _ranks_of(proc, 4)
        rec = tlaunch.main(argv + ["--connect", addr, "--load-requests", "6",
                                   "--offered-rate", "50"], device="cpu")
    finally:
        seen = _stop_server(proc, lines, seen, _children(proc.pid) | kids,
                            group=True)
    stopped = [ln for ln in seen if ln.startswith("[serve] frontend stopped:")]
    assert stopped and '"lm_completed": 6' in stopped[-1]
    assert rec["completed"] == 6 and rec["rejected"] == 0
    args = tlaunch.main.__globals__["argparse"].Namespace(
        arch="qwen3-8b", reduced=True, batch=4, prompt_len=6, max_new=4,
        seed=0, page_size=4, pages_per_device=None, chunk_tokens=4,
        mesh=None)
    _, make_engine = tlaunch._build_lm_engine(args, device="cpu")
    eng = make_engine()
    for r in rec["results"]:
        rng = np.random.default_rng(np.random.SeedSequence([0, 100 + r["uid"]]))
        req = tE.Request(uid=r["uid"], prompt=torch.from_numpy(
            rng.integers(0, 512, 6)), max_new=4)
        eng.submit(req)
        eng.run(max_ticks=40)
        assert r["tokens"] == req.output, r["uid"]


def test_launch_stream_listen_devices_4(tmp_path):
    out = tmp_path / "buckets.pt"
    server = ["--listen", "127.0.0.1:0", "--path", "kernel", "--patients",
              "16", "--buckets", "8,32", "--devices", "4"]
    code = ("import _torch_dist_ranks as R\n"
            "_spawn.run(R.stream_listen_recorded, 4, device='cpu', "
            f"args=({server!r}, {str(out)!r}), until_stopped=True)\n")
    proc, addr, lines, seen = _start_server(code)
    try:
        kids = _ranks_of(proc, 4)
        rec = tstream.main(["--connect", addr, "--patients", "16",
                            "--segments", "4", "--offered-rate", "400"],
                           device="cpu")
    finally:
        _stop_server(proc, lines, seen, _children(proc.pid) | kids)
    assert rec["acked"] == 64 and rec["acks"] == {"enqueued": 64}
    assert rec["stats"]["sched_enqueued_total"] == \
        rec["stats"]["sched_packed_total"] == 64
    buckets = torch.load(out)
    assert buckets["n_devices"] == 4
    # the two warm-up buckets, then at least one a flush
    assert len(buckets["seen"]) >= 2 + rec["stats"]["batches"]
    program = compiler.compile_model(
        vadetect.init(torch.Generator().manual_seed(0), device="cpu"))
    one = FleetRunner(program, path="kernel", device="cpu")
    for x, preds in buckets["seen"]:
        assert torch.equal(one.classify(x), preds)


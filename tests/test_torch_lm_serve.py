"""PyTorch port vs JAX package on LM serving: `quantize_for_serving`,
`generate`, the slot `Engine` (tests/test_serve.py's engine tests,
ported), sampling, seating, and the entry points `launch.serve` (its
open-loop sweeps too) and `examples.serve_lm` on the CPU.

Greedy tokens from float32 configs are held identical to the
reference's; packed trees to identical codes and scales within 1 ulp
(the 1-bit scale is a float32 mean). The port cannot reproduce
`jax.random`, so sampled tokens are held to the reference's properties
(reproducible for a key, invariant to seat order and co-tenancy,
`generate` == `Engine` with the row index as uid, greedy at temperature
<= 0) and the top-k mask to the reference's exactly.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import CPU, DENSE_LM, lm_models, n, np_tokens, t

from repro.serve import engine as jE
from repro.serve import seating as jseat
from repro_torch import obs
from repro_torch._tree import leaves
from repro_torch.examples import serve_lm
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import engine as tE
from repro_torch.serve import seating as tseat


# ---------------------------------------------------------------------------
# quantize_for_serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_quantize_for_serving_tree_matches_reference(bits):
    """Every projection packed, with the reference's codes and scales (a
    1-bit scale within 1 ulp); embeddings, lm_head and norms dense and
    shared with the master tree."""
    mj, mt, pj, pt = lm_models("qwen3_8b", "float32")
    qj = jE.quantize_for_serving(pj, bits)
    qt = tE.quantize_for_serving(pt, bits)
    flat_j = jax.tree_util.tree_flatten_with_path(qj)[0]
    paths_j = sorted("/".join(str(k.key) for k in kp) for kp, _ in flat_j)
    paths_t = []

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        else:
            paths_t.append("/".join(path))

    walk(qt)
    assert sorted(paths_t) == paths_j
    for kp, leaf in flat_j:
        node = qt
        for k in kp:
            node = node[k.key]
        if kp[-1].key == "scale" and kp[-2].key.startswith("w"):
            np.testing.assert_allclose(n(node), np.asarray(leaf), rtol=1e-6,
                                       atol=0)
        else:
            np.testing.assert_array_equal(n(node), np.asarray(leaf))
    wq = qt["blocks"]["pos0"]["mix"]["wq"]
    assert set(wq) == {"packed", "scale"} and wq["packed"].dtype == torch.uint8
    assert qt["embed"]["w"] is pt["embed"]["w"]
    assert "w" in qt["lm_head"]


def test_quantized_params_smaller():
    """tests/test_serve.py's sizes: the blocks shrink below 0.26x at int4
    and 0.45x at int8; the whole tree orders int4 < int8 < dense."""
    _, mt, _, pt = lm_models("qwen3_8b", "float32", max_seq=16)

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in leaves(tree)
                   if isinstance(x, torch.Tensor))

    q4 = tE.quantize_for_serving(pt, bits=4)
    q8 = tE.quantize_for_serving(pt, bits=8)
    assert nbytes(q4["blocks"]) < 0.26 * nbytes(pt["blocks"])
    assert nbytes(q8["blocks"]) < 0.45 * nbytes(pt["blocks"])
    assert nbytes(q4) < nbytes(q8) < nbytes(pt)


def test_quantized_serving_logits_close():
    """int8 weight-only serving keeps the logit surface close to the dense
    path (tests/test_serve.py: correlation > 0.98), and its prefill equals
    the reference's packed prefill on the same packed tree."""
    mj, mt, pj, pt = lm_models("qwen3_8b", "float32", max_seq=40)
    prompts = np_tokens((2, 12), mt.cfg.vocab, seed=1)
    ld, _ = mt.prefill(pt, t(prompts).long())
    qt = tE.quantize_for_serving(pt, bits=8)
    lq, _ = mt.prefill(qt, t(prompts).long())
    corr = np.corrcoef(n(ld).astype(np.float64).ravel(),
                       n(lq).astype(np.float64).ravel())[0, 1]
    assert corr > 0.98, corr
    lq_j, _ = mj.prefill(jE.quantize_for_serving(pj, bits=8), jnp.asarray(prompts))
    err = np.abs(n(lq) - np.asarray(lq_j)).max() / np.abs(np.asarray(lq_j)).max()
    assert err <= 1e-4, err


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE_LM)
def test_generate_greedy_matches_reference(name):
    """Greedy tokens identical to the reference's in float32; the same
    again from a second call (the prefill's fresh cache is the only one
    the decode steps write)."""
    mj, mt, pj, pt = lm_models(name, "float32", max_seq=20)
    prompts = np_tokens((2, 8), mt.cfg.vocab, seed=1)
    want = np.asarray(jE.generate(mj, pj, jnp.asarray(prompts), max_new=6))
    got = tE.generate(mt, pt, t(prompts), max_new=6, device=CPU)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(n(got), want)
    np.testing.assert_array_equal(
        n(tE.generate(mt, pt, t(prompts), max_new=6, device=CPU)), want)


def test_generate_quantized_greedy_matches_reference():
    """The packed path (ops.quant_matmul's plain version here) against the
    reference's packed path: the same greedy tokens at 8 and 4 bits."""
    mj, mt, pj, pt = lm_models("qwen3_8b", "float32", max_seq=20)
    prompts = np_tokens((2, 8), mt.cfg.vocab, seed=2)
    for bits in (8, 4):
        want = jE.generate(mj, jE.quantize_for_serving(pj, bits),
                           jnp.asarray(prompts), max_new=6)
        got = tE.generate(mt, tE.quantize_for_serving(pt, bits), t(prompts),
                          max_new=6, device=CPU)
        np.testing.assert_array_equal(n(got), np.asarray(want))


# ---------------------------------------------------------------------------
# The slot engine (tests/test_serve.py's engine tests)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen():
    """The reduced qwen3-8b in float32, both packages, max_seq 64."""
    return lm_models("qwen3_8b", "float32", max_seq=64)


def _req(mod, uid, prompt, max_new, eos=None):
    return mod.Request(uid=uid, prompt=prompt, max_new=max_new, eos=eos)


def test_engine_slots_and_recycling(qwen):
    _, mt, _, pt = qwen
    eng = tE.Engine(mt, pt, batch_size=2, device=CPU)
    reqs = [_req(tE, i, t(np_tokens((5,), mt.cfg.vocab, i)), 4)
            for i in range(3)]  # 3 requests, 2 slots -> forces recycling
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=50)
    for r in reqs:
        assert r.done and len(r.output) == 4


def test_engine_burst_matches_reference_token_for_token(qwen):
    """A burst of mixed-length requests over a smaller pool (batched
    admission, co-admission, recycling): every request's tokens equal the
    reference engine's, and the admission accounting too."""
    mj, mt, pj, pt = qwen
    lens = (4, 4, 7, 7, 5, 4)
    prompts = [np_tokens((s,), mt.cfg.vocab, 10 + i) for i, s in enumerate(lens)]
    je = jE.Engine(mj, pj, batch_size=3)
    te = tE.Engine(mt, pt, batch_size=3, device=CPU)
    jr = [_req(jE, i, jnp.asarray(p), 5) for i, p in enumerate(prompts)]
    tr = [_req(tE, i, t(p), 5) for i, p in enumerate(prompts)]
    for a, b in zip(jr, tr):
        je.submit(a)
        te.submit(b)
    je.run(max_ticks=60)
    te.run(max_ticks=60)
    assert [r.output for r in tr] == [r.output for r in jr]
    assert (te.admission_prefills, te.admission_rowsteps) == \
        (je.admission_prefills, je.admission_rowsteps)
    # and each equals generate on its own prompt
    for p, r in zip(prompts, tr):
        solo = tE.generate(mt, pt, t(p)[None], max_new=5, device=CPU)
        assert n(solo)[0].tolist() == r.output


def test_engine_eos_on_first_token_recycles_slot(qwen):
    """A request finishing on the tick it was admitted (EOS as its first
    token) must not leak its slot."""
    _, mt, _, pt = qwen
    prompt = t(np_tokens((5,), mt.cfg.vocab, 9))
    probe = _req(tE, 0, prompt, 2)
    eng = tE.Engine(mt, pt, batch_size=1, device=CPU)
    eng.submit(probe)
    eng.tick()
    first = probe.output[0]
    eng = tE.Engine(mt, pt, batch_size=1, device=CPU)
    eos_reqs = [_req(tE, i, prompt, 8, eos=first) for i in range(1, 4)]
    tail = _req(tE, 9, prompt, 3)
    for r in (*eos_reqs, tail):
        eng.submit(r)
    eng.run(max_ticks=30)
    for r in eos_reqs:
        assert r.done and r.output == [first], r
    assert tail.done and len(tail.output) == 3
    assert all(s is None for s in eng._slots)
    assert not bool(eng.active.any())


def test_engine_coadmission_does_not_corrupt_seated_slots(qwen):
    """Admitting B while A is seated re-feeds A its last-fed state (the
    in-place cache's idempotent rewrite): A's output matches a solo run."""
    _, mt, _, pt = qwen
    pa = t(np_tokens((5,), mt.cfg.vocab, 1))
    pb = t(np_tokens((5,), mt.cfg.vocab, 2))
    solo = tE.Engine(mt, pt, batch_size=2, device=CPU)
    ra = _req(tE, 0, pa, 6)
    solo.submit(ra)
    solo.run(max_ticks=20)
    duo = tE.Engine(mt, pt, batch_size=2, device=CPU)
    ra2, rb = _req(tE, 1, pa, 6), _req(tE, 2, pb, 6)
    duo.submit(ra2)
    duo.tick()  # A seated and decoding ...
    duo.submit(rb)  # ... when B arrives
    duo.run(max_ticks=20)
    assert ra2.output == ra.output, (ra2.output, ra.output)


def test_submit_guards_invalid_and_duplicate_uid(qwen):
    _, mt, _, pt = qwen
    eng = tE.Engine(mt, pt, batch_size=2, device=CPU)

    def req(uid, max_new=3):
        return _req(tE, uid, t(np_tokens((4,), mt.cfg.vocab, uid)), max_new)

    for bad in (0, -2):
        with pytest.raises(ValueError, match="max_new must be >= 1"):
            eng.submit(req(0, max_new=bad))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(_req(tE, 5, torch.zeros(0, dtype=torch.long), 3))
    r = req(1)
    eng.submit(r)
    with pytest.raises(ValueError, match="uid already in flight"):
        eng.submit(req(1))
    eng.run(max_ticks=50)
    assert r.done and len(r.output) == 3
    r2 = req(1)  # same uid, prior request finished: legal reuse
    eng.submit(r2)
    eng.run(max_ticks=50)
    assert r2.done and len(r2.output) == 3


def test_engine_telemetry_cells_and_counters(qwen):
    """With telemetry on: the decode, prefill and seat cells are tracked
    (one decode signature for the whole pool), and the admission counters
    mirror the engine's own."""
    _, mt, _, pt = qwen
    tel = obs.configure(enabled=True)
    try:
        eng = tE.Engine(mt, pt, batch_size=2, device=CPU)
        for i in range(3):
            eng.submit(_req(tE, i, t(np_tokens((4 + i % 2,), mt.cfg.vocab, i)), 3))
        eng.run(max_ticks=30)
        sizes = tel.probe.cache_sizes()
        snap = tel.registry.snapshot()
    finally:
        obs.reset()
    assert sizes["serve.decode_step"] == 1
    assert {"serve.prefill", "serve.seat"} <= set(sizes)
    assert snap["counters"]["serve.admission_prefills"] == eng.admission_prefills
    assert snap["counters"]["serve.admission_rowsteps"] == eng.admission_rowsteps
    assert snap["counters"]["serve.completed_total"] == 3


# ---------------------------------------------------------------------------
# Seating
# ---------------------------------------------------------------------------


def test_scatter_and_gather_slots_match_reference(qwen):
    """scatter_slots into a pool and gather_slots back out, against the
    reference's seating on the same cache rows; other slots untouched."""
    mj, mt, pj, pt = qwen
    prompts = np_tokens((3, 6), mt.cfg.vocab, 4)
    _, rows_j = mj.prefill(pj, jnp.asarray(prompts))
    _, rows_t = mt.prefill(pt, t(prompts).long())
    pool_j = mj.init_cache(4)
    pool_t = mt.init_cache(4, device=CPU)
    src, dst = [2, 0], [3, 1]
    pool_j = jseat.scatter_slots(pool_j, rows_j, jnp.asarray(src), jnp.asarray(dst))
    pool_t = tseat.scatter_slots(pool_t, rows_t, src, dst)
    for name, a in pool_t["blocks"]["pos0"]["attn"].items():
        b = pool_j["blocks"]["pos0"]["attn"][name]
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    back = tseat.gather_slots(pool_t, dst)
    for a, b in zip(leaves(back), leaves(tseat.gather_slots(rows_t, src))):
        assert torch.equal(a, b)
    assert tseat.slot_axes(pool_t) == jseat.slot_axes(pool_j)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def test_top_k_mask_equals_the_reference():
    """The mask `sample_tokens` applies: every logit >= the k-th largest
    kept, ties at the threshold included — the reference's two lines on
    the same logits, exactly. Greedy through the mask is plain argmax."""
    rng = np.random.default_rng(0)
    logits = np.round(rng.standard_normal((4, 50)), 1).astype(np.float32)
    for k in (1, 5, 20):
        thresh = jax.lax.top_k(jnp.asarray(logits), k)[0][..., -1:]
        want = np.asarray(jnp.asarray(logits) < thresh)
        got_t = torch.topk(t(logits), k, dim=-1).values[..., -1:]
        np.testing.assert_array_equal(n(t(logits) < got_t), want)
        greedy = tE.sample_tokens(t(logits), [(0,)] * 4, temperature=0.0,
                                  top_k=k)
        np.testing.assert_array_equal(n(greedy), logits.argmax(-1))
        # every draw lands inside the kept set, ties included
        keep = ~want
        for seed in range(30):
            keys = [(seed, r) for r in range(4)]
            tok = n(tE.sample_tokens(t(logits), keys, temperature=5.0, top_k=k))
            assert keep[np.arange(4), tok].all()


def test_sampling_draws_follow_the_distribution():
    """One uniform a (key) draw through the CDF: over many keys the token
    frequencies follow softmax(logits / T)."""
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]])
    p = torch.softmax(logits / 0.8, dim=-1)[0].numpy()
    draws = [int(tE.sample_tokens(logits, [(3, i)], temperature=0.8)[0])
             for i in range(4000)]
    freq = np.bincount(draws, minlength=4) / 4000
    np.testing.assert_allclose(freq, p, atol=0.03)


def test_sampled_streams_are_keyed_and_seat_invariant(qwen):
    """The same key gives the same tokens; another key other tokens;
    temperature <= 0 equals greedy; generate equals the Engine when the
    row index is the uid, whatever the seat order and pool size."""
    _, mt, _, pt = qwen
    prompts = t(np_tokens((3, 6), mt.cfg.vocab, 5))
    kw = dict(max_new=5, greedy=False, temperature=0.9, top_k=40, device=CPU)
    a = tE.generate(mt, pt, prompts, key=tE.prng_key(7), **kw)
    assert torch.equal(a, tE.generate(mt, pt, prompts, key=tE.prng_key(7), **kw))
    assert not torch.equal(a, tE.generate(mt, pt, prompts, key=tE.prng_key(8), **kw))
    cold = tE.generate(mt, pt, prompts, key=tE.prng_key(7),
                       **{**kw, "temperature": 0.0})
    assert torch.equal(cold, tE.generate(mt, pt, prompts, max_new=5, device=CPU))
    for order, pool in (((0, 1, 2), 3), ((2, 0, 1), 2), ((1, 2, 0), 1)):
        eng = tE.Engine(mt, pt, batch_size=pool, greedy=False, temperature=0.9,
                        top_k=40, key=tE.prng_key(7), device=CPU)
        reqs = {uid: _req(tE, uid, prompts[uid], 5) for uid in order}
        for uid in order:
            eng.submit(reqs[uid])
        eng.run(max_ticks=60)
        for uid in range(3):
            assert reqs[uid].output == a[uid].tolist(), (order, pool, uid)


# ---------------------------------------------------------------------------
# Entry points on the CPU
# ---------------------------------------------------------------------------


def test_launch_serve_reduced_on_the_cpu(capsys):
    """`launch.serve.main` at the reduced qwen3-8b: dense, 8-bit and
    sampled; its tokens equal generate on the same build."""
    argv = ["--arch", "qwen3-8b", "--reduced", "--batch", "2",
            "--prompt-len", "6", "--max-new", "4"]
    dense = tlaunch.main(argv, device="cpu")
    q8 = tlaunch.main(argv + ["--quant-bits", "8"], device="cpu")
    hot = tlaunch.main(argv + ["--temperature", "0.8", "--top-k", "20"],
                       device="cpu")
    out = capsys.readouterr().out
    assert "weights quantized to 8 bits" in out and "sampling:" in out
    for rec in (dense, q8, hot):
        assert rec["n_layers"] == 2 and rec["peak_device_bytes"] is None
        assert np.asarray(rec["tokens"]).shape == (2, 4)
    args = tlaunch.main.__globals__["argparse"].Namespace(
        arch="qwen3-8b", reduced=True, batch=2, prompt_len=6, max_new=4,
        quant_bits=8, seed=0)
    cfg, model, params, prompts = tlaunch.build_lm(args, device="cpu")
    assert "packed" in params["blocks"]["pos0"]["ffn"]["w_up"]
    want = tE.generate(model, params, prompts, max_new=4, device=CPU)
    assert q8["tokens"] == want.tolist()


# ---------------------------------------------------------------------------
# the open-loop sweeps of launch.serve (obs.loadlab): wall time, so the
# CPU tests hold structure and accounting, never the knee or the verdict
# ---------------------------------------------------------------------------

SWEEP_ARGV = ["--arch", "qwen3-8b", "--reduced", "--batch", "2",
              "--prompt-len", "6", "--max-new", "3", "--load-requests", "6",
              "--load-fractions", "0.5,4"]


class _TickEngine:
    """A stand-in slot engine for the reference's sweep functions, which
    read only `submit`, `tick`, `_queue`, `run`, `batch` and a request's
    `output` / `done`: each tick seats queued requests up to the pool and
    gives every seated one a token."""

    chunk_tokens = None

    def __init__(self, batch: int = 2, tick_s: float = 0.002):
        self.batch, self.tick_s = batch, tick_s
        self._queue, self._seated = [], []

    def submit(self, req) -> None:
        self._queue.append(req)

    def tick(self) -> int:
        while self._queue and len(self._seated) < self.batch:
            self._seated.append(self._queue.pop(0))
        for r in self._seated:
            r.output.append(0)
            r.done = len(r.output) >= r.max_new
        n_seated = len(self._seated)
        if n_seated:
            time.sleep(self.tick_s)
        self._seated = [r for r in self._seated if not r.done]
        return n_seated

    def run(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if self.tick() == 0 and not self._queue:
                return


def _ref_prompts(n_req: int) -> list:
    return [jnp.zeros((6,), jnp.int32) for _ in range(n_req)]


def _key_tree(x, dynamic=()):
    """The nested keys of a record (list lengths kept; the dicts named in
    `dynamic`, whose keys are counters a run may or may not bump, as a
    marker)."""
    if isinstance(x, dict):
        return {k: "dynamic" if k in dynamic else _key_tree(v, dynamic)
                for k, v in x.items()}
    if isinstance(x, list):
        return [_key_tree(v, dynamic) for v in x]
    return None


def _check_serve_sweep(rec: dict, n_points: int, n_req: int) -> None:
    assert len(rec["points"]) == n_points
    for p in rec["points"]:
        assert p["n_requests"] == n_req and p["latency"]["count"] == n_req
        assert None not in (p["p50_s"], p["p99_s"], p["p999_s"])
        assert p["ttft"]["p50_s"] <= p["latency"]["p50_s"]
    g = rec["coordinated_omission_guard"]
    assert g["intended_ge_dequeue"] and g["samples"] == n_req
    assert rec["slo"]["declared"]["name"] == "serve.ttft.p99"
    assert len(rec["slo"]["points"]) == n_points
    assert rec["overload"]["verdict"] in ("graceful_degradation",
                                          "queue_collapse")


def test_launch_serve_load_sweep_on_the_cpu():
    """`--load-sweep` on the dense reduced qwen3-8b: the reference's
    record, key for key (the reference's `sweep_serve` on a stand-in
    engine), every request accounted for, the CO guard held."""
    from repro.obs import loadlab as jloadlab

    rec = tlaunch.main(SWEEP_ARGV + ["--load-sweep"], device="cpu")
    _check_serve_sweep(rec, 2, 6)
    want = jloadlab.sweep_serve(
        _TickEngine, _ref_prompts, capacity_rps=200.0,
        load_fractions=(0.5, 4.0), n_requests=6, max_new=3, seed=0)
    assert _key_tree(rec) == _key_tree(want)


def test_launch_serve_load_sweep_reaches_the_paged_chunked_engine(
        monkeypatch):
    """`--page-size`, `--pages-per-device` and `--chunk-tokens` reach
    every engine the sweep builds (the capacity drain's and each
    point's), as in the reference."""
    built = []
    real = tlaunch.E.Engine

    def engine(*args, **kw):
        built.append((kw["paging"], kw["chunk_tokens"]))
        return real(*args, **kw)

    monkeypatch.setattr(tlaunch.E, "Engine", engine)
    rec = tlaunch.main(SWEEP_ARGV + ["--load-sweep", "--page-size", "4",
                                     "--pages-per-device", "9",
                                     "--chunk-tokens", "4"], device="cpu")
    _check_serve_sweep(rec, 2, 6)
    assert len(built) == 3
    assert {(pg.page_size, pg.n_pages, c) for pg, c in built} == {(4, 9, 4)}


def test_launch_serve_frontend_sweep_on_the_cpu():
    """`--frontend-sweep` over a loopback socket: exact accounting, typed
    rejections, URGENT segments always enqueued, no segment dropped, the
    transport twin; the reference's record key for key (its
    `sweep_frontend` over its own frontend on a stand-in engine; the
    frontend's counters and the rejection reasons vary with the run)."""
    from repro.obs import loadlab as jloadlab
    from repro.serve import frontend as jfe

    rec = tlaunch.main(SWEEP_ARGV + ["--frontend-sweep", "--patients", "4"],
                       device="cpu")
    assert len(rec["points"]) == 2
    for p in rec["points"]:
        assert p["submitted"] == p["completed"] + p["rejected"] == 6
        assert sum(p["rejected_by_reason"].values()) == p["rejected"]
        assert p["segments"]["urgent_not_enqueued"] == 0
        assert p["segments"]["dropped"] == 0
        assert p["segments"]["sent"] == 12
    assert rec["overload"]["accounting_exact"]
    assert rec["overload"]["urgent_survived"]
    assert rec["overload"]["typed_rejections_only"]
    assert rec["coordinated_omission_guard"]["intended_ge_dequeue"]
    assert set(rec["transport_overhead"]["p99_s"]) == {"socket", "inproc"}

    def make_frontend(fcfg):
        fe = jfe.Frontend(engine=_TickEngine(), n_patients=4, cfg=fcfg)
        fe.warm(6)
        return fe

    want = jloadlab.sweep_frontend(
        make_frontend, _ref_prompts, admission_rate_rps=200.0,
        load_fractions=(0.5, 4.0), n_requests=6, max_new=3, n_patients=4)
    dynamic = ("frontend_stats", "rejected_by_reason")
    assert _key_tree(rec, dynamic) == _key_tree(want, dynamic)


@pytest.mark.parametrize("argv,message", [
    (["--arch", "va-cnn", "--load-sweep"], "repro_torch.launch.stream"),
    (SWEEP_ARGV + ["--load-sweep", "--mesh", "2"], "item 9b"),
    (SWEEP_ARGV + ["--frontend-sweep", "--mesh", "2x1"], "item 9b"),
])
def test_launch_serve_refuses_what_the_sweeps_do_not_drive(argv, message,
                                                            capsys):
    """The reference's refusal of `--load-sweep` for va-cnn, and the
    sweeps over a mesh, which are not ported."""
    with pytest.raises(SystemExit):
        tlaunch.main(argv, device="cpu")
    assert message in capsys.readouterr().err


def test_launch_serve_json_prints_the_sweep_record(capsys):
    rec = tlaunch.main(SWEEP_ARGV + ["--load-sweep", "--json",
                                     "--load-fractions", "1",
                                     "--arrival-process", "trace"],
                       device="cpu")
    out = capsys.readouterr().out
    printed = json.loads(out[out.index("\n{") + 1:])
    assert printed == json.loads(json.dumps(rec, default=float))
    assert [p["load_fraction"] for p in printed["points"]] == [1.0]


def test_launch_serve_va_on_the_cpu():
    rec = tlaunch.main(["--arch", "va-cnn", "--patients", "4"], device="cpu")
    assert len(rec["diagnoses"]) == 4
    assert all(len(d.segment_preds) == 6 for d in rec["diagnoses"])


def test_serve_lm_example_smoke_on_the_cpu():
    """The burst demo's --smoke assertions (batched admission cheaper than
    pool replay, reproducible sampling) on the CPU."""
    rec = serve_lm.main(["--smoke"], device="cpu")
    assert rec["admission_prefills"] == 2 and rec["admission_rowsteps"] == 22
    assert all(len(o) == 4 for o in rec["outputs"])
    assert set(rec["agreement"]) == {8}

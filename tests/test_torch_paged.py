"""PyTorch port vs JAX package on the paged KV cache and chunked prefill
(tests/test_paged_properties.py, one device), and the engine properties of
tests/test_serve_properties.py and tests/test_admission_properties.py that
tests/test_torch_lm_serve.py does not cover.

Every engine run of the port is held three ways on the same numpy weights
(reduced configs in float32) and prompts: against the port's own solo
prefill + decode stream, against the port's dense pool, and against the
reference's engine with the same paging. Tokens are held identical;
decode logits of the occupied slots to the reference within LOGIT_RTOL of
max|logit| (tests/test_torch_lm.py's float32 tolerance), and paged to
dense in the port bit for bit (`torch.equal`: the paged step attends over
the same dense view, and masked scores weigh exactly 0). Idle slots'
logits are never compared: their table rows point at the shared scratch
page.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import CPU, lm_models, n, np_tokens, shared_lm_models, t
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serve import engine as jE
from repro.serve import paging as jpaging
from repro.serve import seating as jseat
from repro_torch import obs
from repro_torch._tree import leaves
from repro_torch.serve import engine as tE
from repro_torch.serve import paging as tpaging
from repro_torch.serve import seating as tseat

ARCHS = ("qwen3_8b", "recurrentgemma_2b", "rwkv6_3b")
MAX_SEQ = 24
PAGE = 4  # divides qwen3's max_seq cap AND recurrentgemma's window (8)
N_PAGES = 16
# sub-page prompts (2, 3), page-crossing (5, 9)
PROMPT_LENS = (2, 3, 5, 9)
LOGIT_RTOL = 1e-4  # port vs reference, of max|logit| (float32)


def _paging(mod, n_pages=N_PAGES):
    return mod.PagingConfig(page_size=PAGE, n_pages=n_pages)


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
    """Both packages' models on the same weights, and the reference's
    engine on shared jitted cells (as its own tests build it)."""
    out = {}
    for name in ARCHS:
        mj, mt, pj, pt = shared_lm_models(name, "float32", max_seq=MAX_SEQ)
        span = jpaging.validate_page_size(PAGE, mj.attn_capacities())
        prefill = jax.jit(mj.prefill)
        decode = jax.jit(mj.decode_step)
        seat_dense = jax.jit(jseat.scatter_slots, donate_argnums=0)
        chunk = jax.jit(jE._chunk_prefill_fn(mj))
        decode_paged = seat_paged = None
        if span:
            decode_paged = jax.jit(
                lambda p, c, tok, pos, tbl, _m=mj:
                _m.decode_step_paged(p, c, tok, pos, tbl, PAGE))
            seat_paged = jax.jit(
                functools.partial(jseat.scatter_pages,
                                  layouts=mj.page_layouts(PAGE)),
                donate_argnums=0)

        class JEngine(jE.Engine):
            def _compile_decode(self, _dense=decode, _paged=decode_paged):
                if self._pg is None:
                    return _dense

                def step(params, cache, tok, pos):
                    return _paged(params, cache, tok, pos,
                                  self._tbl_device())

                return step

            def _admission_cell(self, rows, _p=prefill, _sd=seat_dense,
                                _sp=seat_paged):
                return _p, (_sp if self._pg is not None else _sd), \
                    lambda p: p

            def _chunk_cell(self, c, rows, _chunk=chunk, _m=mj):
                return (_chunk, lambda: _m.init_cache(rows),
                        lambda x: jnp.asarray(x, jnp.int32))

        out[name] = (mj, mt, pj, pt, JEngine)
    return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _specs(vocab, rng, count, *, lens=PROMPT_LENS, eos_pool=None,
           max_new=(1, 5)):
    """(uid, numpy prompt, max_new, eos) of `count` random requests."""
    out = []
    for i in range(count):
        s_len = int(rng.choice(lens))
        eos = None
        if eos_pool is not None and rng.random() < 0.4:
            eos = int(rng.choice(eos_pool))
        out.append((i, np_tokens((s_len,), vocab, 1000 + i),
                    int(rng.integers(*max_new)), eos))
    return out


def _port_reqs(specs):
    return [tE.Request(uid=u, prompt=t(p).long(), max_new=m, eos=e)
            for u, p, m, e in specs]


def _ref_reqs(specs):
    return [jE.Request(uid=u, prompt=jnp.asarray(p), max_new=m, eos=e)
            for u, p, m, e in specs]


def _solo(mt, pt, req) -> list:
    """The port's solo greedy prefill + decode stream (the `generate`
    recipe), truncated the way the engine truncates."""
    prompt = torch.as_tensor(req.prompt).long()[None]
    s = prompt.shape[1]
    logits, cache = mt.prefill(pt, prompt)
    tok = torch.argmax(logits, dim=-1)
    out = []
    for step in range(req.max_new):
        out.append(int(tok[0]))
        if (req.eos is not None and out[-1] == req.eos) or \
                len(out) >= req.max_new:
            break
        logits, cache = mt.decode_step(pt, cache, tok,
                                       torch.full((1,), s + step))
        tok = torch.argmax(logits, dim=-1)
    return out


def _record(eng) -> list:
    """Wrap `eng`'s decode cell: every call appends (logits as numpy,
    occupied-slot mask) to the returned log."""
    log, inner = [], eng._decode

    def step(params, cache, tok, pos):
        logits, cache = inner(params, cache, tok, pos)
        log.append((np.array(n(logits)),
                    np.array([s is not None for s in eng._slots])))
        return logits, cache

    eng._decode = step
    return log


def _drive(eng, reqs, rng, max_steps=200):
    """A random submit / tick interleaving until every request drains."""
    pending = list(reqs)
    steps = 0
    while (pending or eng._queue or eng._chunks or eng._chunk_wait
           or any(s is not None for s in eng._slots)) and steps < max_steps:
        steps += 1
        if pending and (rng.random() < 0.6 or not eng._queue):
            for _ in range(int(rng.integers(1, 3))):
                if pending:
                    eng.submit(pending.pop(0))
        eng.tick()
    assert steps < max_steps, "interleaving did not drain"


def _run_all(eng, reqs, max_ticks=80):
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=max_ticks)
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


def _check_logs(port, ref, *, paged=None):
    """Occupied rows: the port's decode logits within LOGIT_RTOL of the
    reference's, and (given the port's dense log) equal to `paged`'s bit
    for bit."""
    assert len(port) == len(ref)
    for (lt, occ), (lj, occ_j) in zip(port, ref):
        np.testing.assert_array_equal(occ, occ_j)
        err = np.abs(lt[occ] - lj[occ]).max() / np.abs(lj[occ]).max()
        assert err <= LOGIT_RTOL, err
    if paged is not None:
        assert len(paged) == len(port)
        for (lp, occ_p), (ld, occ) in zip(paged, port):
            np.testing.assert_array_equal(occ_p, occ)
            assert np.array_equal(lp[occ], ld[occ])


# ---------------------------------------------------------------------------
# Paged vs dense vs the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
@settings(max_examples=4, deadline=None)
@given(
    batch_size=st.sampled_from([2, 3]),
    n_reqs=st.integers(1, 5),
    seed=st.integers(0, 10_000),
)
def test_paged_engine_matches_dense_generate_and_reference(
    built, name, batch_size, n_reqs, seed
):
    """Token for token, under the same random admit/tick interleaving
    (sub-page and page-crossing prompts, EOS cuts, slot and page
    recycling): the port's paged engine == its dense engine == its solo
    stream == the reference's paged engine; paged decode logits equal the
    dense ones bit for bit and the reference's within LOGIT_RTOL."""
    mj, mt, pj, pt, JEngine = built[name]
    probe = _solo(mt, pt, tE.Request(uid=0, prompt=t(np_tokens(
        (PROMPT_LENS[0],), mt.cfg.vocab, 1000)).long(), max_new=4))
    streams, logs = {}, {}
    for label, make in (
        ("dense", lambda: tE.Engine(mt, pt, batch_size=batch_size,
                                    device=CPU)),
        ("paged", lambda: tE.Engine(mt, pt, batch_size=batch_size,
                                    paging=_paging(tpaging), device=CPU)),
        ("ref", lambda: JEngine(mj, pj, batch_size=batch_size,
                                paging=_paging(jpaging))),
    ):
        rng = np.random.default_rng(seed)
        specs = _specs(mt.cfg.vocab, rng, n_reqs, eos_pool=probe)
        eng = make()
        logs[label] = _record(eng)
        reqs = (_ref_reqs if label == "ref" else _port_reqs)(specs)
        _drive(eng, reqs, rng)
        if eng._pg is not None:
            eng._pg.check_invariants()
            assert eng._pg.allocated_pages() == 0, "pages leaked"
        assert all(r.done for r in reqs), label
        streams[label] = {r.uid: r.output for r in reqs}
    assert streams["paged"] == streams["dense"] == streams["ref"]
    for u, p, m, e in specs:
        want = _solo(mt, pt, tE.Request(uid=u, prompt=t(p).long(),
                                        max_new=m, eos=e))
        assert streams["paged"][u] == want, (name, u)
    _check_logs(logs["dense"], logs["ref"], paged=logs["paged"])


@pytest.mark.parametrize("name", ("qwen3_8b", "recurrentgemma_2b"))
def test_page_boundary_prompt_lengths(built, name):
    """Prompts of one sub-page, exactly one page, and page-crossing
    lengths decode to the solo stream through the paged pool, as the
    reference's paged engine does."""
    mj, mt, pj, pt, JEngine = built[name]
    specs = [(i, np_tokens((s,), mt.cfg.vocab, 40 + i), 5, None)
             for i, s in enumerate((2, PAGE, PAGE + 1, 2 * PAGE + 1))]
    eng = tE.Engine(mt, pt, batch_size=2, paging=_paging(tpaging),
                    device=CPU)
    reqs = _port_reqs(specs)
    got = _run_all(eng, reqs, 60)
    assert got == [_solo(mt, pt, r) for r in reqs]
    assert got == _run_all(JEngine(mj, pj, batch_size=2,
                                   paging=_paging(jpaging)),
                           _ref_reqs(specs), 60)


def test_paged_cache_bytes_reclaimed(built):
    """`cache_bytes_in_use`: 0 at rest, grows while tenants hold pages,
    below the dense pool's while running, and back to 0 once the pool
    drains — tick for tick the reference's figure."""
    mj, mt, pj, pt, JEngine = built["qwen3_8b"]
    specs = [(i, np_tokens((5,), mt.cfg.vocab, 60 + i), 4, None)
             for i in range(3)]
    trace = {}
    for label, eng, reqs in (
        ("paged", tE.Engine(mt, pt, batch_size=2, paging=_paging(tpaging),
                            device=CPU), _port_reqs(specs)),
        ("dense", tE.Engine(mt, pt, batch_size=2, device=CPU),
         _port_reqs(specs)),
        ("ref", JEngine(mj, pj, batch_size=2, paging=_paging(jpaging)),
         _ref_reqs(specs)),
    ):
        assert eng.cache_bytes_in_use() == 0
        for r in reqs:
            eng.submit(r)
        trace[label] = []
        for _ in range(40):
            busy = eng.tick()
            trace[label].append(eng.cache_bytes_in_use())
            if busy == 0 and not eng._queue:
                break
        assert all(r.done for r in reqs)
        assert eng.cache_bytes_in_use() == 0
    assert trace["paged"] == trace["ref"]
    assert max(trace["paged"]) > 0
    assert all(p < d for p, d in zip(trace["paged"], trace["dense"]) if d)


def test_pure_recurrent_paging_degenerates_to_dense(built):
    """rwkv6 has nothing to page (span 0): a paged engine builds the
    ordinary dense cache, runs no allocator, and streams the solo tokens,
    as the reference's does."""
    mj, mt, pj, pt, JEngine = built["rwkv6_3b"]
    eng = tE.Engine(mt, pt, batch_size=2, paging=_paging(tpaging),
                    device=CPU)
    assert eng._pg is None
    dense = mt.init_cache(2, device=CPU)
    assert [(p, x.shape) for p, x in tseat._leaf_paths(eng.cache)] == \
        [(p, x.shape) for p, x in tseat._leaf_paths(dense)]
    specs = [(0, np_tokens((5,), mt.cfg.vocab, 70), 4, None)]
    reqs = _port_reqs(specs)
    assert _run_all(eng, reqs, 20) == [_solo(mt, pt, reqs[0])]
    jeng = JEngine(mj, pj, batch_size=2, paging=_paging(jpaging))
    assert jeng._pg is None
    assert _run_all(jeng, _ref_reqs(specs), 20) == [reqs[0].output]


def test_mixed_capacity_paging_where_the_reference_raises():
    """gemma2 alternates local (window 8) and global (max_seq 24)
    attention, so its blocks take 2 and 6 pages a slot. The port's seating
    writes each block's own first cap/page table entries, as the paged
    decode reads them: paged equals dense. The reference's
    `scatter_pages` writes every table entry into every block's pool and
    raises on such a model (ROADMAP.md §3, a known difference)."""
    mj, mt, pj, pt = shared_lm_models("gemma2_9b", "float32", max_seq=MAX_SEQ)
    assert set(mt.page_layouts(PAGE).values()) == {(2, PAGE), (6, PAGE)}
    specs = [(i, np_tokens((s,), mt.cfg.vocab, 80 + i), 6, None)
             for i, s in enumerate((3, 9, 13))]
    outs = {}
    for label, kw in (("dense", {}), ("paged", {"paging": _paging(tpaging)})):
        eng = tE.Engine(mt, pt, batch_size=2, device=CPU, **kw)
        outs[label] = _run_all(eng, _port_reqs(specs))
    assert outs["paged"] == outs["dense"]
    jeng = jE.Engine(mj, pj, batch_size=2, paging=_paging(jpaging))
    jeng.submit(_ref_reqs(specs)[0])
    with pytest.raises((ValueError, TypeError)):
        jeng.tick()


# ---------------------------------------------------------------------------
# The allocator
# ---------------------------------------------------------------------------


def _replay(alloc, ops, exhausted):
    """Run an op tape, auditing invariants after every op; returns what
    each op did (the layout trace)."""
    trace = []
    for op, owner, size in ops:
        shard = owner % alloc.n_shards
        try:
            if op == "reserve":
                alloc.reserve(owner, size, shard)
                trace.append(("reserve", owner, size))
            elif op == "alloc":
                trace.append(("alloc", owner, alloc.alloc(owner)))
            else:  # free / shed are both a full release
                trace.append(("free", owner, alloc.free(owner)))
        except exhausted:
            trace.append(("exhausted", owner, None))
        except ValueError:
            trace.append(("invalid", owner, None))
        alloc.check_invariants()
    return trace


@settings(max_examples=15, deadline=None)
@given(
    n_pages=st.sampled_from([8, 12, 16]),
    n_shards=st.sampled_from([1, 2]),
    seed=st.integers(0, 10_000),
)
def test_allocator_fuzz_matches_reference(n_pages, n_shards, seed):
    """Random reserve/alloc/free/shed tapes: the partition stays exact
    after every op, errors are typed, an identical tape replays the
    identical layout, and the layout is the reference allocator's."""
    if n_pages % n_shards:
        n_pages += n_shards - (n_pages % n_shards)
    rng = np.random.default_rng(seed)
    ops = [(str(rng.choice(["reserve", "alloc", "free", "shed"])),
            int(rng.integers(0, 6)), int(rng.integers(1, 5)))
           for _ in range(60)]
    ex_t, ex_j = tpaging.PagesExhaustedError, jpaging.PagesExhaustedError
    a = _replay(tpaging.PageAllocator(n_pages, n_shards), ops, ex_t)
    assert a == _replay(tpaging.PageAllocator(n_pages, n_shards), ops, ex_t)
    assert a == _replay(jpaging.PageAllocator(n_pages, n_shards), ops, ex_j)
    alloc = tpaging.PageAllocator(n_pages, n_shards)
    _replay(alloc, ops, ex_t)
    for owner in range(6):
        alloc.free(owner)
    alloc.check_invariants()
    assert alloc.allocated_pages() == 0
    for s in range(n_shards):
        assert alloc.available(s) == alloc.usable_per_shard


def test_allocator_typed_errors():
    """Exhaustion is PagesExhaustedError, misuse ValueError, and scratch
    is never handed out."""
    alloc = tpaging.PageAllocator(8, 2)  # 4 pages/shard: 3 usable + scratch
    with pytest.raises(tpaging.PagesExhaustedError):
        alloc.reserve("big", 4, 0)
    alloc.reserve("a", 3, 0)
    with pytest.raises(ValueError):
        alloc.reserve("a", 1, 0)
    with pytest.raises(tpaging.PagesExhaustedError):
        alloc.reserve("b", 1, 0)
    alloc.reserve("b", 1, 1)
    with pytest.raises(ValueError):
        alloc.alloc("nobody")
    pages = [alloc.alloc("a") for _ in range(3)]
    assert alloc.scratch(0) not in pages and alloc.scratch(1) not in pages
    with pytest.raises(tpaging.PagesExhaustedError):
        alloc.alloc("a")
    assert alloc.free("a") == 3
    alloc.check_invariants()


def test_submit_rejects_never_satisfiable_request(built):
    """A request whose worst case exceeds the whole usable pool raises the
    typed PagesExhaustedError at submit and leaves no residue, as in the
    reference; `admissible` agrees with the reference's."""
    mj, mt, pj, pt, JEngine = built["qwen3_8b"]
    eng = tE.Engine(mt, pt, batch_size=2, paging=_paging(tpaging, 3),
                    device=CPU)
    jeng = JEngine(mj, pj, batch_size=2, paging=_paging(jpaging, 3))
    p = np_tokens((9,), mt.cfg.vocab, 0)
    with pytest.raises(tpaging.PagesExhaustedError):
        eng.submit(tE.Request(uid=0, prompt=t(p).long(), max_new=8))
    with pytest.raises(jpaging.PagesExhaustedError):
        jeng.submit(jE.Request(uid=0, prompt=jnp.asarray(p), max_new=8))
    assert 0 not in eng._inflight
    for s_len in (1, 2, 5, 9):
        for m in (1, 2, 6, 8):
            assert eng.admissible(s_len, m) == jeng.admissible(s_len, m)


def test_admission_defers_until_pages_free(built):
    """Exhaustion at admission is deferral: two satisfiable-but-not-
    together requests serialize through the pool and finish with their
    solo streams, as in the reference."""
    mj, mt, pj, pt, JEngine = built["qwen3_8b"]
    specs = [(i, np_tokens((9,), mt.cfg.vocab, 80 + i), 6, None)
             for i in range(2)]
    eng = tE.Engine(mt, pt, batch_size=2, paging=_paging(tpaging, 6),
                    device=CPU)
    reqs = _port_reqs(specs)
    for r in reqs:
        eng.submit(r)
    eng.tick()
    assert sum(s is not None for s in eng._slots) == 1
    assert len(eng._queue) == 1
    eng.run(max_ticks=40)
    assert [r.output for r in reqs] == [_solo(mt, pt, r) for r in reqs]
    eng._pg.check_invariants()
    assert eng._pg.allocated_pages() == 0
    assert [r.output for r in reqs] == _run_all(
        JEngine(mj, pj, batch_size=2, paging=_paging(jpaging, 6)),
        _ref_reqs(specs), 40)


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ("qwen3_8b", "recurrentgemma_2b"))
def test_chunked_prefill_does_not_starve_shorts(built, name):
    """A max-length prompt submitted first does not delay co-submitted
    shorts: they admit on the first tick and are the first TTFT
    observations, while the long prompt prefills in chunks and gets its
    first token within ceil(len/chunk) + 1 ticks. Every stream equals the
    reference's chunked paged engine's."""
    mj, mt, pj, pt, JEngine = built[name]
    long_len = MAX_SEQ - 6
    specs = [(0, np_tokens((long_len,), mt.cfg.vocab, 90), 4, None)] + [
        (1 + i, np_tokens((3,), mt.cfg.vocab, 91 + i), 4, None)
        for i in range(2)]
    tel = obs.configure(enabled=True)
    try:
        eng = tE.Engine(mt, pt, batch_size=3, paging=_paging(tpaging),
                        chunk_tokens=PAGE, device=CPU)
        long, *shorts = reqs = _port_reqs(specs)
        ttft = tel.registry.histogram("serve.ttft_s")
        for r in reqs:
            eng.submit(r)
        eng.tick()
        assert all(len(r.output) >= 1 for r in shorts), "short starved"
        assert ttft.count == 2, ttft.count
        budget = -(-long_len // PAGE) + 1
        ticks = 1
        while not long.output and ticks < budget + 1:
            eng.tick()
            ticks += 1
        assert long.output and ticks <= budget, (ticks, budget)
        assert ttft.count == 3
        eng.run(max_ticks=40)
        assert all(r.done for r in reqs)
    finally:
        obs.reset()
    for r in shorts:
        assert r.output == _solo(mt, pt, r), r.uid
    assert [r.output for r in reqs] == _run_all(
        JEngine(mj, pj, batch_size=3, paging=_paging(jpaging),
                chunk_tokens=PAGE), _ref_reqs(specs), 40)


@pytest.mark.parametrize("name", ("qwen3_8b", "recurrentgemma_2b"))
def test_chunked_prefill_paged_matches_dense(built, name):
    """The chunk cell is the same computation over both pools: the port's
    dense-chunked and paged-chunked engines give the same tokens and bit
    for bit the same decode logits, and the reference's chunked paged
    engine the same tokens (logits within LOGIT_RTOL)."""
    mj, mt, pj, pt, JEngine = built[name]
    specs = [(i, np_tokens((s,), mt.cfg.vocab, 95 + i), 4, None)
             for i, s in enumerate((13, 2, 9, 3))]
    outs, logs = {}, {}
    for label, eng, reqs in (
        ("dense", tE.Engine(mt, pt, batch_size=2, chunk_tokens=PAGE,
                            device=CPU), _port_reqs(specs)),
        ("paged", tE.Engine(mt, pt, batch_size=2, chunk_tokens=PAGE,
                            paging=_paging(tpaging), device=CPU),
         _port_reqs(specs)),
        ("ref", JEngine(mj, pj, batch_size=2, chunk_tokens=PAGE,
                        paging=_paging(jpaging)), _ref_reqs(specs)),
    ):
        logs[label] = _record(eng)
        outs[label] = _run_all(eng, reqs, 60)
        assert eng.admission_rowsteps == sum(len(p) for _, p, _, _ in specs)
    assert outs["dense"] == outs["paged"] == outs["ref"]
    _check_logs(logs["dense"], logs["ref"], paged=logs["paged"])


def test_chunk_cell_equals_prefill():
    """The chunked-prefill cell (decode steps over the real tokens of each
    chunk, no pad steps) leaves the cache and the last logits a prefill of
    the whole prompt gives, for an attention and a recurrent stack."""
    for name in ("qwen3_8b", "recurrentgemma_2b"):
        _, mt, _, pt = shared_lm_models(name, "float32", max_seq=MAX_SEQ)
        prompt = t(np_tokens((1, 11), mt.cfg.vocab, 5)).long()
        want, _ = mt.prefill(pt, prompt)
        cache = mt.init_cache(1, device=CPU)
        cell = tE._chunk_prefill_fn(mt)
        for lo in range(0, 11, PAGE):
            hi = min(lo + PAGE, 11)
            logits, cache = cell(pt, cache, prompt[:, lo:hi],
                                 torch.arange(lo, hi)[None], hi - lo)
        err = float((logits - want).abs().max() / want.abs().max())
        assert err <= LOGIT_RTOL, (name, err)


# ---------------------------------------------------------------------------
# Seating
# ---------------------------------------------------------------------------


def _np_rows(mt, rows: int, seed: int) -> dict:
    """A random dense rows-cache of `mt`'s structure, as numpy."""
    rng = np.random.default_rng(seed)
    tmpl = mt.init_cache(rows, device=CPU)

    def fill(x):
        if x.dtype == torch.int32:
            return rng.integers(-1, 50, tuple(x.shape)).astype(np.int32)
        return rng.standard_normal(tuple(x.shape)).astype(np.float32)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return fill(tree)

    return walk(tmpl)


def _tree(np_tree, conv):
    if isinstance(np_tree, dict):
        return {k: _tree(v, conv) for k, v in np_tree.items()}
    return conv(np_tree)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _paths(v, path + (k,)).items()}
    return {path: tree}


@pytest.mark.parametrize("name", ("qwen3_8b", "recurrentgemma_2b"))
def test_scatter_then_gather_pages_match_reference(built, name):
    """`scatter_pages` seats dense rows into the paged pool under a page
    mapping exactly as the reference's does (every leaf equal), and
    `gather_pages` recovers the rows bit for bit — paged K/V leaves and
    dense slot_pos / recurrent leaves alike."""
    mj, mt, _, _, _ = built[name]
    span = tpaging.validate_page_size(PAGE, mt.attn_capacities())
    rows_np = _np_rows(mt, 2, 5)
    pool_t = mt.init_cache_paged(4, N_PAGES, PAGE, device=CPU)
    pool_j = mj.init_cache_paged(4, N_PAGES, PAGE)
    phys = np.asarray([list(range(span)), list(range(span, 2 * span))])
    src, dst = [0, 1], [1, 3]
    tseat.scatter_pages(pool_t, _tree(rows_np, t), src, dst, phys,
                        layouts=mt.page_layouts(PAGE))
    pool_j = jseat.scatter_pages(
        pool_j, _tree(rows_np, jnp.asarray), jnp.asarray(src),
        jnp.asarray(dst), jnp.asarray(phys, jnp.int32),
        layouts=mj.page_layouts(PAGE))
    got, want = _paths(pool_t), _paths(pool_j)
    assert got.keys() == want.keys()
    for path, x in got.items():
        np.testing.assert_array_equal(n(x), np.asarray(want[path]), path)
    back = tseat.gather_pages(pool_t, dst, phys,
                              layouts=mt.page_layouts(PAGE))
    for a, b in zip(leaves(back), leaves(_tree(rows_np, t))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ("qwen3_8b", "rwkv6_3b"))
def test_scatter_then_gather_slots_preserves_others(built, name):
    """Dense seating: gather returns exactly the seated rows, the other
    slots are bit-untouched, and the pool equals the reference's seating
    of the same rows."""
    mj, mt, _, _, _ = built[name]
    rows_np = _np_rows(mt, 2, 7)
    pool = mt.init_cache(4, device=CPU)
    before = [x.clone() for x in leaves(tseat.gather_slots(pool, [0, 2]))]
    tseat.scatter_slots(pool, _tree(rows_np, t), [0, 1], [3, 1])
    for a, b in zip(leaves(tseat.gather_slots(pool, [3, 1])),
                    leaves(_tree(rows_np, t))):
        assert torch.equal(a, b)
    for a, b in zip(leaves(tseat.gather_slots(pool, [0, 2])), before):
        assert torch.equal(a, b)
    ref = jseat.scatter_slots(mj.init_cache(4), _tree(rows_np, jnp.asarray),
                              jnp.asarray([0, 1]), jnp.asarray([3, 1]))
    want = _paths(ref)
    for path, x in _paths(pool).items():
        np.testing.assert_array_equal(n(x), np.asarray(want[path]), path)


def test_scatter_rejects_mismatched_trees(built):
    _, mt, _, _, _ = built["qwen3_8b"]
    with pytest.raises(ValueError, match="leaves"):
        tseat.scatter_slots(mt.init_cache(2, device=CPU),
                            {"not": torch.zeros(1)}, [0], [0])
    with pytest.raises(ValueError, match="leaves"):
        tseat.scatter_pages(mt.init_cache_paged(2, N_PAGES, PAGE, device=CPU),
                            {"not": torch.zeros(1)}, [0], [0], [[0]],
                            layouts=mt.page_layouts(PAGE))


def test_paging_config_and_page_math():
    """PagingConfig validation and the pages_for_position ring cap, equal
    to the reference's arithmetic."""
    with pytest.raises(ValueError):
        tpaging.PagingConfig(page_size=0, n_pages=8)
    with pytest.raises(ValueError):
        tpaging.PagingConfig(page_size=4, n_pages=1)
    with pytest.raises(ValueError):
        tpaging.validate_page_size(5, (24, 8))
    assert tpaging.validate_page_size(4, (24, 8)) == 6
    assert tpaging.validate_page_size(4, ()) == 0
    for last in (-1, 0, 3, 4, 23, 1000):
        for span in (0, 6):
            assert tpaging.pages_for_position(last, 4, span) == \
                jpaging.pages_for_position(last, 4, span)
    assert tpaging.pages_for_position(1000, 4, 6) == 6


def test_paged_layouts_and_cache_equal_the_reference(built):
    """`page_layouts`, `attn_capacities` and `init_cache_paged`'s leaves
    (paths, shapes, dtypes) equal the reference's, for every family."""
    for name in ARCHS:
        mj, mt, _, _, _ = built[name]
        assert mt.attn_capacities() == mj.attn_capacities()
        if not mt.attn_capacities():
            continue
        assert mt.page_layouts(PAGE) == mj.page_layouts(PAGE)
        got = _paths(mt.init_cache_paged(3, N_PAGES, PAGE, device=CPU))
        want = _paths(mj.init_cache_paged(3, N_PAGES, PAGE))
        assert got.keys() == want.keys()
        for path, x in got.items():
            assert tuple(x.shape) == want[path].shape, path
            assert str(x.dtype).split(".")[-1] == str(want[path].dtype), path
    with pytest.raises(ValueError, match="does not divide"):
        built["qwen3_8b"][1].page_layouts(5)


def test_int8_kv_paged_equals_dense():
    """The int8 KV cache (values and per-slot scales paged alike): paged
    and dense engines give the same tokens and bit for bit the same
    decode logits, and the reference's paged engine the same tokens."""
    mj, mt, pj, pt = lm_models("qwen3_8b", "float32", max_seq=MAX_SEQ,
                               kv_quant_bits=8)
    specs = [(i, np_tokens((s,), mt.cfg.vocab, 30 + i), 5, None)
             for i, s in enumerate((3, 5, 9))]
    outs, logs = {}, {}
    for label, kw in (("dense", {}), ("paged", {"paging": _paging(tpaging)})):
        eng = tE.Engine(mt, pt, batch_size=2, device=CPU, **kw)
        logs[label] = _record(eng)
        outs[label] = _run_all(eng, _port_reqs(specs))
    assert outs["paged"] == outs["dense"]
    for (lp, occ_p), (ld, occ) in zip(logs["paged"], logs["dense"]):
        assert np.array_equal(lp[occ], ld[occ])
    assert outs["paged"] == _run_all(
        jE.Engine(mj, pj, batch_size=2, paging=_paging(jpaging)),
        _ref_reqs(specs))


# ---------------------------------------------------------------------------
# Slot invariants and the replay shim (tests/test_serve_properties.py)
# ---------------------------------------------------------------------------


def _check_slots(eng):
    occ = [i for i, s in enumerate(eng._slots) if s is not None]
    assert len(occ) <= eng.batch
    # active flags mirror occupancy exactly
    assert torch.nonzero(eng.active).flatten().tolist() == occ
    for i in occ:
        req = eng._slots[i]
        assert not req.done and 1 <= len(req.output) < req.max_new


@pytest.mark.parametrize("paged", [False, True])
@settings(max_examples=8, deadline=None)
@given(
    batch_size=st.sampled_from([1, 2]),
    n_reqs=st.integers(1, 5),
    seed=st.integers(0, 10_000),
)
def test_random_interleavings_keep_slot_invariants(
    built, paged, batch_size, n_reqs, seed
):
    """Random submit/tick interleavings never exceed capacity, keep the
    active flags equal to occupancy, and starve nobody; the streams equal
    the reference engine's under the same interleaving."""
    mj, mt, pj, pt, JEngine = built["qwen3_8b"]
    kw = ({"paging": _paging(tpaging)} if paged else {})
    outs = []
    for eng, wrap in (
        (tE.Engine(mt, pt, batch_size=batch_size, device=CPU, **kw),
         _port_reqs),
        (JEngine(mj, pj, batch_size=batch_size,
                 **({"paging": _paging(jpaging)} if paged else {})),
         _ref_reqs),
    ):
        rng = np.random.default_rng(seed)
        reqs = wrap(_specs(mt.cfg.vocab, rng, n_reqs, lens=(1, 2, 3, 4),
                           max_new=(1, 4)))
        pending, steps = list(reqs), 0
        while (pending or eng._queue
               or any(s is not None for s in eng._slots)) and steps < 200:
            steps += 1
            if pending and (rng.random() < 0.5 or not eng._queue):
                for _ in range(int(rng.integers(1, 3))):
                    if pending:
                        eng.submit(pending.pop(0))
            eng.tick()
            if wrap is _port_reqs:
                _check_slots(eng)
        assert steps < 200
        for r in reqs:
            assert r.done and 1 <= len(r.output) <= r.max_new
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("paged", [False, True])
@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_committed_replay_is_bitwise_noop_on_cache(built, paged, seed):
    """After any ticked state, decoding the pool with its last-fed
    (token, pos) leaves every cache leaf bit-identical: attention K/V
    writes depend only on (token, pos). Paged, the idle rows all rewrite
    scratch, which is outside the check's meaning but inside the cache:
    their rows' table entries point there, so scratch is excluded."""
    _, mt, _, pt, _ = built["qwen3_8b"]
    rng = np.random.default_rng(seed)
    kw = {"paging": _paging(tpaging)} if paged else {}
    eng = tE.Engine(mt, pt, batch_size=2, device=CPU, **kw)
    for i in range(2):
        eng.submit(tE.Request(uid=i, prompt=t(np_tokens(
            (int(rng.integers(1, 5)),), mt.cfg.vocab, seed + i)).long(),
            max_new=6))
    for _ in range(int(rng.integers(1, 4))):
        eng.tick()
    before = [x.clone() for x in leaves(eng.cache)]
    eng._decode(eng.params, eng.cache, eng._ctok, eng._cpos)
    scratch = eng._pg.scratch() if paged else None
    for (parts, x), b in zip(tseat._leaf_paths(eng.cache), before):
        if paged and tseat._leaf_layout(parts, eng._layouts) is not None:
            keep = torch.arange(x.shape[1]) != scratch
            assert torch.equal(x[:, keep], b[:, keep]), parts
        else:
            assert torch.equal(x, b), parts


@pytest.mark.parametrize("paged", [False, True])
def test_step_single_replay_is_bitwise_noop(built, paged):
    """`_step_single` re-feeding a slot its last-fed (token, pos) leaves
    the cache (scratch aside) bit-identical and the slot's pending state
    untouched."""
    _, mt, _, pt, _ = built["qwen3_8b"]
    kw = {"paging": _paging(tpaging)} if paged else {}
    eng = tE.Engine(mt, pt, batch_size=2, device=CPU, **kw)
    eng.submit(tE.Request(uid=0, prompt=t(np_tokens((5,), mt.cfg.vocab,
                                                    7)).long(), max_new=8))
    eng.tick()
    before = [x.clone() for x in leaves(eng.cache)]
    pending = (int(eng.tokens[0]), int(eng.pos[0]))
    eng._step_single(0, int(eng._ctok[0]), int(eng._cpos[0]))
    for (parts, x), b in zip(tseat._leaf_paths(eng.cache), before):
        if paged and tseat._leaf_layout(parts, eng._layouts) is not None:
            keep = torch.arange(x.shape[1]) != eng._pg.scratch()
            assert torch.equal(x[:, keep], b[:, keep]), parts
        else:
            assert torch.equal(x, b), parts
    assert (int(eng.tokens[0]), int(eng.pos[0])) == pending


# ---------------------------------------------------------------------------
# Sampling machinery (tests/test_admission_properties.py)
# ---------------------------------------------------------------------------


def test_greedy_outputs_unaffected_by_sampling_machinery(built):
    """An engine built with sampling parameters but greedy=True streams
    what the default engine and the solo stream do, paged too."""
    _, mt, _, pt, _ = built["qwen3_8b"]
    specs = [(i, np_tokens((3,), mt.cfg.vocab, 1000 + i), 4, None)
             for i in range(2)]
    outs = []
    for kw in ({}, {"temperature": 0.7, "top_k": 3, "key": tE.prng_key(99)},
               {"temperature": 0.7, "top_k": 3, "paging": _paging(tpaging)}):
        eng = tE.Engine(mt, pt, batch_size=2, greedy=True, device=CPU, **kw)
        outs.append(_run_all(eng, _port_reqs(specs), 20))
    assert outs[0] == outs[1] == outs[2]
    assert outs[0] == [_solo(mt, pt, r) for r in _port_reqs(specs)]


def test_sampled_streams_paged_equal_dense(built):
    """Sampled streams are a function of (key, uid, t): the paged pool
    draws the dense pool's tokens."""
    _, mt, _, pt, _ = built["qwen3_8b"]
    specs = [(i, np_tokens((s,), mt.cfg.vocab, 20 + i), 5, None)
             for i, s in enumerate((3, 5, 9))]
    outs = []
    for kw in ({}, {"paging": _paging(tpaging)}):
        eng = tE.Engine(mt, pt, batch_size=2, greedy=False, temperature=0.8,
                        top_k=5, key=tE.prng_key(7), device=CPU, **kw)
        outs.append(_run_all(eng, _port_reqs(specs)))
    assert outs[0] == outs[1]


def test_sample_tokens_topk_edge_cases():
    """k=1 is argmax at any temperature; k >= vocab equals unmasked
    sampling; temperature <= 0 is greedy; tied maxima both stay eligible
    and a key's draw is deterministic."""
    v = 11
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((3, v)).astype(np.float32))
    keys = [(i,) for i in range(3)]
    argmax = torch.argmax(logits, -1)
    assert torch.equal(tE.sample_tokens(logits, keys, temperature=2.5,
                                        top_k=1), argmax)
    full = tE.sample_tokens(logits, keys, temperature=0.9, top_k=0)
    for k in (v, v + 7):
        assert torch.equal(tE.sample_tokens(logits, keys, temperature=0.9,
                                            top_k=k), full)
    assert torch.equal(tE.sample_tokens(logits, keys, temperature=0.0,
                                        top_k=4), argmax)
    tied = torch.zeros((1, v))
    tied[0, 2] = tied[0, 9] = 5.0
    draws = set()
    for i in range(64):
        a = int(tE.sample_tokens(tied, [(100 + i,)], temperature=1.0,
                                 top_k=1)[0])
        assert a == int(tE.sample_tokens(tied, [(100 + i,)],
                                         temperature=1.0, top_k=1)[0])
        draws.add(a)
    assert draws == {2, 9}


def test_submit_refuses_token_ids_outside_the_vocabulary(built):
    """An out-of-range token id is refused at submit (torch raises where
    jnp clamps an embedding index; on the card it would be a device-side
    assert), leaving no residue."""
    _, mt, _, pt, _ = built["qwen3_8b"]
    eng = tE.Engine(mt, pt, batch_size=2, device=CPU)
    for bad in ([1, mt.dims.vocab], [-1, 2]):
        with pytest.raises(ValueError, match="outside the vocabulary"):
            eng.submit(tE.Request(uid=0, prompt=torch.tensor(bad),
                                  max_new=2))
    assert not eng._inflight and not eng._queue

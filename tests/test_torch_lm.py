"""PyTorch port vs JAX package on the LM substrate of the dense decoder
families: configs, `layers.linear_apply` in its three formats, attention
(train and decode paths), and `prefill` + `decode_step` of the reduced
dense configs on the same numpy weights.

Tolerances: attention at tests/test_attention.py's (2e-3; 1e-5 for the
blocked decode against the direct one); prefill and decode logits at
tests/test_serve.py's bfloat16 tolerances (rtol = atol = 3e-2, 4e-2),
and at 1e-4 of max|logit| in float32 (the two packages sum in other
orders); a packed or sparse linear at 1e-5 of max|y| in float32 (the
kernel's plain version sums x @ unpack(W) in float32, as the reference
does) and at the bfloat16 tolerance in bfloat16 (the reference rounds x,
the unpacked weight and the scale to bfloat16; the port's kernel takes
float32 x and rounds once).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import CPU, DENSE_LM, lm_models, n, np_tokens, t

from repro import configs as jconfigs
from repro.models import attention as jA
from repro.models import layers as jL
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import api as tapi
from repro_torch.models import attention as tA
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.serve import engine as tE

BF16 = dict(rtol=3e-2, atol=3e-2)
BF16_DECODE = dict(rtol=4e-2, atol=4e-2)
F32_REL = 1e-4
LINEAR_F32_REL = 1e-5
ATTN = dict(rtol=2e-3, atol=2e-3)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def to_np(x) -> np.ndarray:
    """bf16-safe numpy float32 view of a tensor or jax array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", tconfigs.ALL_ARCHS)
def test_configs_equal_the_reference(name):
    """Every architecture's full CONFIG and REDUCED, field for field, and
    the padded dims, as the reference has them."""
    for which in ("get", "reduced"):
        jc = getattr(jconfigs, which)(name)
        tc = getattr(tconfigs, which)(name)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (tc.hd, tc.n_groups, tc.tail) == (jc.hd, jc.n_groups, jc.tail)
        for tp in (1, 8):
            assert dataclasses.asdict(tT.Dims.create(tc, tp)) == \
                dataclasses.asdict(jT.Dims.create(jc, tp))
    cli = {v: k for k, v in tconfigs.CLI_IDS.items()}[name]
    assert tconfigs.get(cli) == tconfigs.get(name)


# ---------------------------------------------------------------------------
# linear_apply in its three formats
# ---------------------------------------------------------------------------


def _x_w(m, k, nn, lead, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, m, k)).astype(np.float32)
    w = (rng.standard_normal((*lead, k, nn)) * k ** -0.5).astype(np.float32)
    return x, w


def _assert_linear(y_t, y_j, dtype):
    if dtype == "float32":
        assert rel(to_np(y_t), to_np(y_j)) <= LINEAR_F32_REL
    else:
        np.testing.assert_allclose(to_np(y_t), to_np(y_j), **BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_packed_linear_matches_reference(bits, stacked, dtype):
    """compile_linear_quant's packed tree (identical codes; 1-bit scales
    are a float32 mean, within 1 ulp) and linear_apply's packed branch on
    it — the port's through ops.quant_matmul (its plain version here) —
    against the reference's XLA unpack + matmul. K = 60 is not a multiple
    of the values a byte holds at 2 and 1 bits, so x's K is padded."""
    lead = (3,) if stacked else ()
    x, w = _x_w(5, 60, 24, lead, seed=bits)
    jp = jL.compile_linear_quant({"w": jnp.asarray(w), "b": jnp.ones(24)}, bits)
    tp_ = tL.compile_linear_quant({"w": t(w), "b": torch.ones(24)}, bits)
    np.testing.assert_array_equal(n(tp_["packed"]), np.asarray(jp["packed"]))
    np.testing.assert_allclose(n(tp_["scale"]), np.asarray(jp["scale"]),
                               rtol=1e-6, atol=0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for g in range(3 if stacked else 1):
        pick = (lambda a: a[g]) if stacked else (lambda a: a)
        jg = {k: pick(v) if k != "b" else v for k, v in jp.items()}
        tg = {k: pick(v) if k != "b" else v for k, v in tp_.items()}
        y_j = jL.linear_apply(jg, jnp.asarray(x), dtype=jdt)
        y_t = tL.linear_apply(tg, t(x), dtype=tdt)
        assert y_t.dtype == tdt and y_t.shape == (2, 5, 24)
        _assert_linear(y_t, y_j, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_sparse_linear_matches_reference(bits, dtype):
    """compile_linear_sparse_quant's values/select/scale and linear_apply's
    sparse branch (the port's through ops.nm_spmm) against the reference.
    K = 40 pads to 48 for the 16:8 groups, so x's K is padded too."""
    x, w = _x_w(5, 40, 24, (), seed=10 + bits)
    jp = jL.compile_linear_sparse_quant({"w": jnp.asarray(w)}, bits)
    tp_ = tL.compile_linear_sparse_quant({"w": t(w)}, bits)
    for key in ("values_q", "select"):
        np.testing.assert_array_equal(n(tp_[key]), np.asarray(jp[key]))
    np.testing.assert_allclose(n(tp_["scale"]), np.asarray(jp["scale"]),
                               rtol=1e-6, atol=0)
    assert tp_["meta"] == {"group": 16, "keep": 8, "bits": bits}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    y_j = jL.linear_apply(jp, jnp.asarray(x), dtype=jdt)
    y_t = tL.linear_apply(tp_, t(x), dtype=tdt)
    _assert_linear(y_t, y_j, dtype)
    # and through the numpy carry-over of the reference's own tree
    tree = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    _assert_linear(tL.linear_apply(tree, t(x), dtype=tdt), y_j, dtype)


@pytest.mark.parametrize("spe", [None, "sparse8"])
def test_dense_linear_matches_reference(spe):
    """The dense {"w"} branch in float32, bare and under the SPE's QAT
    constraints (prune-STE + fake-quant)."""
    from repro.core.spe import SPEConfig as JSPE
    from repro_torch.core.spe import SPEConfig as TSPE

    x, w = _x_w(5, 48, 24, (), seed=3)
    js, ts_ = (JSPE(), TSPE()) if spe else (None, None)
    y_j = jL.linear_apply({"w": jnp.asarray(w)}, jnp.asarray(x), spe=js,
                          dtype=jnp.float32)
    y_t = tL.linear_apply({"w": t(w)}, t(x), spe=ts_, dtype=torch.float32)
    assert rel(n(y_t), y_j) <= LINEAR_F32_REL


def test_norms_rope_ffn_embed_match_reference():
    """The small layers: rms/layer norm, RoPE and M-RoPE, SwiGLU and GeGLU
    (jax.nn.gelu is the tanh form), the scaled embedding, the softcap."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    ln = {"scale": rng.standard_normal(16).astype(np.float32),
          "bias": rng.standard_normal(16).astype(np.float32)}
    for kind in ("rmsnorm", "layernorm"):
        p = {k: v for k, v in ln.items() if kind == "layernorm" or k == "scale"}
        got = tL.norm_apply(kind, {k: t(v) for k, v in p.items()}, t(x))
        want = jL.norm_apply(kind, {k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
        np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-5)
    pos = np.broadcast_to(np.arange(6), (2, 6)).astype(np.int32)
    pos3 = np.stack([pos, pos + 1, pos * 2], axis=1)
    for p_, sec in ((pos, ()), (pos3, (4, 2, 2))):
        got = tL.apply_rope(t(x), t(p_), theta=1e6, sections=sec)
        want = jL.apply_rope(jnp.asarray(x), jnp.asarray(p_), theta=1e6,
                             sections=sec)
        np.testing.assert_allclose(n(got), want, rtol=1e-4, atol=1e-4)
    h = rng.standard_normal((2, 3, 16)).astype(np.float32)
    ffn = {k: {"w": rng.standard_normal((16, 32) if k != "w_down" else (32, 16))
               .astype(np.float32) * 0.2} for k in ("w_gate", "w_up", "w_down")}
    for act in ("swiglu", "geglu", "gelu"):
        pp = ffn if act != "gelu" else {k: ffn[k] for k in ("w_up", "w_down")}
        got = tL.ffn_apply({k: {"w": t(v["w"])} for k, v in pp.items()}, t(h),
                           act=act, dtype=torch.float32)
        want = jL.ffn_apply({k: {"w": jnp.asarray(v["w"])} for k, v in pp.items()},
                            jnp.asarray(h), act=act, dtype=jnp.float32)
        np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-5)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    toks = np_tokens((2, 5), 50, 5)
    for dt in (torch.bfloat16, torch.float32):
        jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
        got = tL.embed_apply({"w": t(table)}, t(toks).long(), dtype=dt, scale=True)
        want = jL.embed_apply({"w": jnp.asarray(table)}, jnp.asarray(toks),
                              dtype=jdt, scale=True)
        np.testing.assert_array_equal(to_np(got), to_np(want))
    np.testing.assert_allclose(n(tL.softcap(t(x) * 40, 30.0)),
                               jL.softcap(jnp.asarray(x) * 40, 30.0),
                               rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# Attention (tests/test_attention.py's cases)
# ---------------------------------------------------------------------------


def _qkv(seed, b, s, h, kv, hd):
    """tests/test_attention.py's inputs (the same jax.random draws), as
    numpy."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return tuple(np.asarray(jax.random.normal(k, shape)) for k, shape in (
        (k1, (b, s, h, hd)), (k2, (b, s, kv, hd)), (k3, (b, s, kv, hd))))


def _both(fn_t, fn_j, arrays, **kw):
    return (n(fn_t(*[t(a) for a in arrays], **kw)),
            np.asarray(fn_j(*[jnp.asarray(a) for a in arrays], **kw)))


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("kind,window", [
    ("global", 0), ("local", 16), ("local", 7), ("chunked", 16),
    ("chunked", 24),  # S % chunk != 0 -> padded path
])
def test_blockwise_attention_matches_reference(kind, window, cap):
    arrays = _qkv(0, 2, 64, 8, 4, 16)
    kw = dict(kind=kind, window=window, cap=cap)
    got, want = _both(tA.attention, jA.attention, arrays, block_q=16,
                      block_k=16, **kw)
    np.testing.assert_allclose(got, want, **ATTN)
    oracle, _ = _both(tA.attention_reference, jA.attention_reference, arrays, **kw)
    np.testing.assert_allclose(got, oracle, **ATTN)


@pytest.mark.parametrize("case", ["softcap_bidirectional", "cross", "mqa", "mha"])
def test_attention_variants_match_reference(case):
    if case == "softcap_bidirectional":
        arrays, kw = _qkv(1, 2, 32, 4, 4, 8), dict(cap=30.0, causal=False)
    elif case == "cross":
        arrays = (_qkv(2, 2, 24, 4, 4, 8)[0], *_qkv(3, 2, 40, 4, 4, 8)[1:])
        kw = dict(causal=False)
    else:
        arrays, kw = _qkv(4, 1, 32, 8, 1 if case == "mqa" else 8, 8), {}
    got, want = _both(tA.attention, jA.attention, arrays, block_q=8,
                      block_k=8, **kw)
    np.testing.assert_allclose(got, want, **ATTN)
    oracle, _ = _both(tA.attention_reference, jA.attention_reference, arrays, **kw)
    np.testing.assert_allclose(got, oracle, **ATTN)


def test_bf16_scores_knob_matches_reference():
    """`score_dtype(bfloat16)`: the blockwise scores and softmax in
    bfloat16 on both sides, held at the bfloat16 tolerance."""
    arrays = _qkv(0, 2, 64, 8, 4, 16)
    with tA.score_dtype(torch.bfloat16), jA.score_dtype(jnp.bfloat16):
        got, want = _both(tA.attention, jA.attention, arrays, block_q=16,
                          block_k=16)
    np.testing.assert_allclose(got, want, **BF16)


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("kind,window", [
    ("global", 0), ("local", 16), ("chunked", 16),
])
def test_decode_attention_matches_reference(kind, window, cap):
    b, s = 2, 48
    q, k, v = _qkv(5, b, s, 8, 4, 16)
    slot_pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    pos = np.full((b,), s - 1, np.int32)
    kw = dict(kind=kind, window=window, cap=cap)
    got, want = _both(tA.attention_decode, jA.attention_decode,
                      (q[:, -1], k, v, slot_pos, pos), **kw)
    np.testing.assert_allclose(got, want, **ATTN)
    full, _ = _both(tA.attention_reference, jA.attention_reference, (q, k, v), **kw)
    np.testing.assert_allclose(got, full[:, -1], **ATTN)


def test_decode_blocked_path_matches_direct():
    """Caches > block_k take the online-softmax loop: same result."""
    b, s = 2, 64
    q, k, v = _qkv(6, b, s, 4, 2, 8)
    slot_pos = t(np.broadcast_to(np.arange(s), (b, s)).astype(np.int32))
    pos = torch.full((b,), s - 1, dtype=torch.int32)
    direct = tA.attention_decode(t(q[:, -1]), t(k), t(v), slot_pos, pos, block_k=s)
    blocked = tA.attention_decode(t(q[:, -1]), t(k), t(v), slot_pos, pos, block_k=16)
    np.testing.assert_allclose(n(blocked), n(direct), rtol=1e-5, atol=1e-5)
    want = jA.attention_decode(jnp.asarray(q[:, -1]), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(n(slot_pos)),
                               jnp.asarray(n(pos)), block_k=16)
    np.testing.assert_allclose(n(blocked), want, rtol=1e-5, atol=1e-5)


def test_decode_ring_buffer_masks_invalid():
    """Empty slots (-1) contribute exactly nothing: the result equals
    attention over the 3 valid slots alone."""
    k, v, q = (np.asarray(jax.random.normal(jax.random.PRNGKey(i), shape))
               for i, shape in ((7, (1, 8, 2, 4)), (8, (1, 8, 2, 4)),
                                (9, (1, 2, 4))))
    slot_pos = np.array([[0, 1, 2, -1, -1, -1, -1, -1]], np.int32)
    got = tA.attention_decode(t(q), t(k), t(v), t(slot_pos), torch.tensor([2]))
    ref = tA.attention_reference(t(q[:, None]), t(k[:, :3]), t(v[:, :3]),
                                 causal=False)[:, 0]
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-4, atol=1e-4)
    # garbage in the empty slots changes nothing at all
    k2, v2 = k.copy(), v.copy()
    k2[:, 3:], v2[:, 3:] = 1e4, -1e4
    again = tA.attention_decode(t(q), t(k2), t(v2), t(slot_pos), torch.tensor([2]))
    assert torch.equal(again, got)


# ---------------------------------------------------------------------------
# The decoder stack: prefill + decode against the reference
# ---------------------------------------------------------------------------


S, B, NEW = 12, 2, 3


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", DENSE_LM)
def test_prefill_and_decode_match_reference(name, dtype):
    """The same weights and tokens through both packages: the prefill's
    last logits and cache, then NEW decode steps (the port updating its
    cache in place), and the teacher-forced forward.

    In bfloat16 the reference is compiled with XLA's
    `xla_allow_excess_precision` off, so it rounds every intermediate to
    bfloat16, as its source says and as the port does. By default XLA
    keeps some in float32 inside its fusions: the compiled reference then
    differs from itself op by op by up to 0.031 in the qwen3 reduced
    stack's final hidden state, as much as it differs from the port."""
    mj, mt, pj, pt = lm_models(name, dtype, max_seq=S + NEW + 1)
    allt = np_tokens((B, S + NEW), mt.cfg.vocab, seed=1)

    def ref(fn, *args):
        if dtype == "float32":
            return fn(*args)
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)

    def check(got, want, tol):
        if dtype == "float32":
            assert rel(n(got), want) <= F32_REL
        else:
            np.testing.assert_allclose(n(got), np.asarray(want), **tol)

    lj, cj = ref(mj.prefill, pj, jnp.asarray(allt[:, :S]))
    lt, ct = mt.prefill(pt, t(allt[:, :S]).long())
    assert lt.dtype == torch.float32 and lt.shape == (B, mt.dims.vocab)
    check(lt, lj, BF16)
    np.testing.assert_array_equal(
        n(ct["blocks"]["pos0"]["attn"]["slot_pos"]),
        np.asarray(cj["blocks"]["pos0"]["attn"]["slot_pos"]))
    for step in range(NEW):
        pos = np.full((B,), S + step, np.int32)
        lj, cj = ref(mj.decode_step, pj, cj, jnp.asarray(allt[:, S + step]),
                     jnp.asarray(pos))
        lt, ct2 = mt.decode_step(pt, ct, t(allt[:, S + step]).long(),
                                 t(pos).long())
        assert ct2 is ct  # updated in place
        check(lt, lj, BF16_DECODE)
    full_j, _ = ref(lambda p, x: jT.forward_train(p, x, mj.cfg, mj.dims),
                    pj, jnp.asarray(allt))
    full_t, _ = tT.forward_train(pt, t(allt).long(), mt.cfg, mt.dims)
    check(full_t, full_j, BF16)


def test_int8_kv_cache_matches_reference():
    """`kv_quant_bits=8`: int8 K/V with per-slot-per-head scales, built by
    the prefill and written by each decode step, as the reference."""
    mj, mt, pj, pt = lm_models("qwen3_8b", "float32", max_seq=S + NEW + 1,
                               kv_quant_bits=8)
    allt = np_tokens((B, S + NEW), mt.cfg.vocab, seed=2)
    lj, cj = mj.prefill(pj, jnp.asarray(allt[:, :S]))
    lt, ct = mt.prefill(pt, t(allt[:, :S]).long())
    kj, kt = cj["blocks"]["pos0"]["attn"], ct["blocks"]["pos0"]["attn"]
    assert kt["k"].dtype == torch.int8
    assert np.abs(n(kt["k"]).astype(int) - np.asarray(kj["k"]).astype(int)).max() <= 1
    assert rel(n(lt), lj) <= F32_REL
    for step in range(NEW):
        pos = np.full((B,), S + step, np.int32)
        lj, cj = mj.decode_step(pj, cj, jnp.asarray(allt[:, S + step]),
                                jnp.asarray(pos))
        lt, ct = mt.decode_step(pt, ct, t(allt[:, S + step]).long(),
                                t(pos).long())
        assert rel(n(lt), lj) <= F32_REL


def test_in_place_decode_is_idempotent_on_a_refeed():
    """The in-place cache: re-feeding a row its last (token, pos) rewrites
    the same ring slot with the same K/V — the cache stays bit for bit —
    and a decode from a clone equals one from the original."""
    _, mt, _, pt = lm_models("gemma2_9b", "float32", max_seq=S + NEW + 1)
    toks = t(np_tokens((B, S + 1), mt.cfg.vocab, seed=3)).long()
    _, cache = mt.prefill(pt, toks[:, :S])
    pos = torch.full((B,), S, dtype=torch.long)
    lg1, cache = mt.decode_step(pt, cache, toks[:, S], pos)
    snap = tE.seating.gather_slots(cache, list(range(B)))
    lg2, cache = mt.decode_step(pt, cache, toks[:, S], pos)
    for a, b in zip(_leaves(snap), _leaves(cache)):
        assert torch.equal(a, b)
    assert torch.equal(lg1, lg2)


def _leaves(tree):
    from repro_torch._tree import leaves

    return leaves(tree)


def test_paging_and_training_raise():
    """The paged cache raises where the page does not divide an attention
    capacity, as the reference's does (the paged cache itself is held in
    tests/test_torch_paged.py); the training loss, which raised before it
    was ported, equals the reference's (its gradients and every family:
    tests/test_torch_lm_train.py)."""
    mj, mt, pj, pt = lm_models("qwen3_8b", "float32", max_seq=16)
    with pytest.raises(ValueError, match="does not divide"):
        tT.init_cache_paged(mt.cfg, mt.dims, 2, 8, 5, 16)
    with pytest.raises(ValueError, match="does not divide"):
        tT.paged_layouts(mt.cfg, 5, 16)
    assert tT.paged_layouts(mt.cfg, 4, 16) == {"blocks/pos0/attn": (4, 4)}
    toks = np_tokens((B, 17), mt.cfg.vocab, seed=5)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    lt, met_t = mt.loss(pt, {k: t(v) for k, v in batch.items()})
    lj, met_j = mj.loss(pj, {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(lt) == pytest.approx(float(lj), rel=1e-5)
    assert float(met_t["nll"]) == pytest.approx(float(met_j["nll"]), rel=1e-5)

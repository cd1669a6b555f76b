"""PyTorch port vs JAX package on the whisper encoder-decoder
(`models.whisper`): the encoder, the teacher-forced decoder, `prefill`
with frames and `decode_step` of the reduced whisper-tiny on the same
numpy weights and frames, packed serving, the cache layout, and the
decoder-only serving entry points that refuse it.

Tolerances as tests/test_torch_lm.py's: 1e-4 of max|logit| in float32 (the
two packages sum in other orders), tests/test_serve.py's bfloat16
tolerances (rtol = atol = 3e-2, 4e-2) in bfloat16 with the reference
compiled with `xla_allow_excess_precision` off, and 1e-4 of max|logit|
for packed 8-bit against the reference's XLA branch (float32); greedy
tokens, packed codes and layouts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import CPU, n, np_tokens, shared_lm_models, t

from repro.models import whisper as jW
from repro.serve import engine as jE
from repro_torch.launch import serve as tlaunch
from repro_torch.models import whisper as tW
from repro_torch.serve import engine as tE

BF16 = dict(rtol=3e-2, atol=3e-2)
BF16_DECODE = dict(rtol=4e-2, atol=4e-2)
F32_REL = 1e-4
S, B, NEW = 12, 2, 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are small: one intra-op thread, so that the
    suite's parallel workers do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_COMPILED: dict = {}


def compiled(fn, dtype: str, *args):
    """`fn` compiled once for `args`' shapes (keyed on `fn` itself: the
    shared models hand every test the same functions); in bfloat16 with
    XLA's `xla_allow_excess_precision` off, so the reference rounds every
    op to bfloat16 as its source says and as the port does."""
    key = (fn, dtype, tuple(np.shape(a) for a in jax.tree.leaves(args)))
    if key not in _COMPILED:
        opts = ({} if dtype == "float32"
                else {"xla_allow_excess_precision": False})
        _COMPILED[key] = jax.jit(fn).lower(*args).compile(
            compiler_options=opts)
    return _COMPILED[key]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def frames(cfg, seed: int = 3) -> np.ndarray:
    """Stub-frontend frame embeddings (B, enc_seq, d_model), float32."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def layout(tree) -> dict:
    return {
        "/".join(str(k.key) for k in kp): (
            tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
        for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def test_sinusoid_matches_reference():
    for length, d in ((16, 48), (1500, 384)):
        np.testing.assert_allclose(n(tW._sinusoid(length, d)),
                                   np.asarray(jW._sinusoid(length, d)),
                                   rtol=1e-5, atol=2e-4)


def test_encoder_and_teacher_forced_decoder_match_reference():
    """`encode` and `decode_train` in float32 on the same weights."""
    mj, mt, pj, pt = shared_lm_models("whisper_tiny", "float32")
    fr = frames(mt.cfg)
    toks = np_tokens((B, S + NEW), mt.cfg.vocab, seed=1)
    enc_j = jW.encode(pj, jnp.asarray(fr), mj.cfg, mj.dims)
    enc_t = tW.encode(pt, t(fr), mt.cfg, mt.dims)
    assert rel(n(enc_t), enc_j) <= F32_REL
    full_j = jW.decode_train(pj, jnp.asarray(toks), enc_j, mj.cfg, mj.dims)
    full_t = tW.decode_train(pt, t(toks).long(), enc_t, mt.cfg, mt.dims)
    assert full_t.dtype == torch.float32
    assert rel(n(full_t), full_j) <= F32_REL


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_and_decode_match_reference(dtype):
    """`prefill(params, tokens, frames)` and NEW decode steps (the port
    updating its cache in place) against the reference, and the cache
    leaf for leaf: the self-attention ring and cross_k / cross_v under
    "dec" with the layer axis first."""
    mj, mt, pj, pt = shared_lm_models("whisper_tiny", dtype)
    fr = frames(mt.cfg)
    allt = np_tokens((B, S + NEW), mt.cfg.vocab, seed=1)

    def ref(fn, *args):
        return compiled(fn, dtype, *args)(*args)

    def check(got, want, tol):
        if dtype == "float32":
            assert rel(n(got), want) <= F32_REL
        else:
            np.testing.assert_allclose(n(got), np.asarray(want), **tol)

    lj, cj = ref(mj.prefill, pj, jnp.asarray(allt[:, :S]), jnp.asarray(fr))
    lt, ct = mt.prefill(pt, t(allt[:, :S]).long(), t(fr))
    assert lt.shape == (B, mt.dims.vocab) and lt.dtype == torch.float32
    check(lt, lj, BF16)
    assert layout(ct) == layout(cj)
    assert layout(mt.init_cache(B, device=CPU)) == layout(mj.init_cache(B))
    check(ct["dec"]["cross_k"].float(), jnp.asarray(cj["dec"]["cross_k"],
                                                    jnp.float32), BF16)
    for step in range(NEW):
        pos = np.full((B,), S + step, np.int32)
        lj, cj = ref(mj.decode_step, pj, cj, jnp.asarray(allt[:, S + step]),
                     jnp.asarray(pos))
        lt, ct2 = mt.decode_step(pt, ct, t(allt[:, S + step]).long(),
                                 t(pos).long())
        assert ct2 is ct
        check(lt, lj, BF16_DECODE)


def test_decode_matches_teacher_forced():
    """tests/test_serve.py's check on the port alone, in bfloat16 and in
    float32, at its tolerances."""
    for dtype in ("bfloat16", "float32"):
        _, mt, _, pt = shared_lm_models("whisper_tiny", dtype)
        fr = t(frames(mt.cfg, seed=4))
        allt = t(np_tokens((B, S + NEW), mt.cfg.vocab, seed=2)).long()
        last, cache = mt.prefill(pt, allt[:, :S], fr)
        full = tW.decode_train(pt, allt, tW.encode(pt, fr, mt.cfg, mt.dims),
                               mt.cfg, mt.dims)
        np.testing.assert_allclose(n(last), n(full[:, S - 1]), **BF16)
        for i in range(NEW):
            pos = torch.full((B,), S + i, dtype=torch.long)
            lg, cache = mt.decode_step(pt, cache, allt[:, S + i], pos)
            np.testing.assert_allclose(n(lg), n(full[:, S + i]), **BF16_DECODE)


def test_greedy_decode_matches_reference():
    """A greedy loop of 6 steps from the prefill, float32: the same
    tokens as the reference's."""
    mj, mt, pj, pt = shared_lm_models("whisper_tiny", "float32")
    fr = frames(mt.cfg, seed=5)
    prompts = np_tokens((B, 8), mt.cfg.vocab, seed=6)
    lj, cj = mj.prefill(pj, jnp.asarray(prompts), jnp.asarray(fr))
    lt, ct = mt.prefill(pt, t(prompts).long(), t(fr))
    tj, tt = jnp.argmax(lj, -1), torch.argmax(lt, -1)
    for i in range(6):
        np.testing.assert_array_equal(n(tt), np.asarray(tj))
        pos = np.full((B,), 8 + i, np.int32)
        lj, cj = mj.decode_step(pj, cj, tj, jnp.asarray(pos))
        lt, ct = mt.decode_step(pt, ct, tt, t(pos).long())
        tj, tt = jnp.argmax(lj, -1), torch.argmax(lt, -1)


def test_packed_8bit_matches_reference():
    """quantize_for_serving's tree equals the reference's (every
    projection and FFN linear packed, biases kept; embed, pos_emb and
    norms dense), and the packed prefill and decode steps (the port's
    through ops.quant_matmul's plain version) equal the reference's XLA
    branch."""
    mj, mt, pj, pt = shared_lm_models("whisper_tiny", "float32")
    qj, qt = jE.quantize_for_serving(pj, 8), tE.quantize_for_serving(pt, 8)
    assert layout(qt) == layout(qj)
    for kp, leaf in jax.tree_util.tree_flatten_with_path(qj)[0]:
        node = qt
        for k in kp:
            node = node[k.key]
        if kp[-1].key == "scale" and kp[-2].key.startswith("w"):
            np.testing.assert_allclose(n(node), np.asarray(leaf), rtol=1e-6)
        else:
            np.testing.assert_array_equal(n(node), np.asarray(leaf))
    assert "packed" in qt["enc_blocks"]["attn"]["wq"]
    assert "b" in qt["dec_blocks"]["cross_attn"]["wo"]
    assert qt["pos_emb"] is pt["pos_emb"]
    fr = frames(mt.cfg, seed=7)
    allt = np_tokens((B, S + NEW), mt.cfg.vocab, seed=8)
    args = (qj, jnp.asarray(allt[:, :S]), jnp.asarray(fr))
    lj, cj = compiled(mj.prefill, "float32", *args)(*args)
    lt, ct = mt.prefill(qt, t(allt[:, :S]).long(), t(fr))
    assert rel(n(lt), lj) <= F32_REL
    for step in range(NEW):
        pos = np.full((B,), S + step, np.int32)
        args = (qj, cj, jnp.asarray(allt[:, S + step]), jnp.asarray(pos))
        lj, cj = compiled(mj.decode_step, "float32", *args)(*args)
        lt, ct = mt.decode_step(qt, ct, t(allt[:, S + step]).long(),
                                t(pos).long())
        assert rel(n(lt), lj) <= F32_REL


def test_init_layout_equals_the_reference():
    """The port's own init (a torch.Generator draw) gives the reference's
    param tree leaf for leaf, `pos_emb` sized to max_seq."""
    mj, mt, pj, _ = shared_lm_models("whisper_tiny", "float32")
    p = mt.init(0, device=CPU)
    assert layout(p) == layout(pj)
    assert p["pos_emb"].shape == (mt.max_seq, mt.cfg.d_model)


@pytest.mark.parametrize("entry", ["engine", "generate", "launch.serve"])
def test_decoder_only_entry_points_refuse_whisper(entry):
    """The slot engine, generate and launch.serve raise
    EncDecUnsupportedError for whisper, as the reference's do."""
    mj, mt, pj, pt = shared_lm_models("whisper_tiny", "float32")
    prompts = np_tokens((1, 4), mt.cfg.vocab, seed=0)
    if entry == "engine":
        with pytest.raises(jE.EncDecUnsupportedError):
            jE.Engine(mj, pj, batch_size=2)
        with pytest.raises(tE.EncDecUnsupportedError, match="slot engine"):
            tE.Engine(mt, pt, batch_size=2, device=CPU)
    elif entry == "generate":
        with pytest.raises(jE.EncDecUnsupportedError):
            jE.generate(mj, pj, jnp.asarray(prompts), max_new=2)
        with pytest.raises(tE.EncDecUnsupportedError, match="generate"):
            tE.generate(mt, pt, t(prompts), max_new=2, device=CPU)
    else:
        with pytest.raises(tE.EncDecUnsupportedError):
            tlaunch.main(["--arch", "whisper-tiny", "--reduced", "--batch",
                          "1", "--prompt-len", "4", "--max-new", "2"],
                         device="cpu")
    assert issubclass(tE.EncDecUnsupportedError, TypeError)


def test_loss_raises_naming_the_training_item():
    """whisper's training loss (encode -> decode_train -> CE), which raised
    before it was ported, and its gradients against the reference's: loss
    within 1e-5 relative, gradients within 1e-4 in tree-relative L1."""
    from repro_torch._tree import leaves, tree_map

    mj, mt, pj, pt = shared_lm_models("whisper_tiny", "float32")
    toks = np_tokens((2, 9), mt.cfg.vocab, seed=6)
    frames = np.random.default_rng(6).standard_normal(
        (2, mt.cfg.enc_seq, mt.cfg.d_model)).astype(np.float32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "frames": frames}
    live = tree_map(lambda p: p.detach().requires_grad_(True), pt)
    lt, met_t = mt.loss(live, {k: t(v) for k, v in batch.items()})
    gt = torch.autograd.grad(lt, leaves(live))
    (lj, met_j), gj = jax.jit(jax.value_and_grad(mj.loss, has_aux=True))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(lt) == pytest.approx(float(lj), rel=1e-5)
    assert float(met_t["nll"]) == float(met_t["loss"])
    it = iter(gt)
    pairs = []
    tree_map(lambda w, g: pairs.append((n(next(it)), np.asarray(g))), live, gj)
    num = sum(float(np.abs(a - b).sum()) for a, b in pairs)
    assert num / sum(float(np.abs(b).sum()) for _, b in pairs) <= 1e-4

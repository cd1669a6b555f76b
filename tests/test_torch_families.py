"""PyTorch port vs JAX package on the MoE, RG-LRU and RWKV-6 families:
`models.moe`, `models.rglru` and `models.rwkv6` (twins of
tests/test_moe.py and tests/test_recurrent.py), and the decoder stack of
the reduced olmoe, llama4-scout, recurrentgemma and rwkv6 configs through
`prefill`, `decode_step`, `forward_train`, `quantize_for_serving`,
`generate` and the slot `Engine`, on the same numpy weights.

Tolerances:
  * the modules in float32 at 1e-5 of max|y| (the two packages sum in
    other orders; the port runs the RG-LRU recurrence as a float32 loop
    over S where the reference runs an associative scan), and the
    reference's own tests' tolerances for their self-consistency checks
    (2e-3 MoE against a per-token loop, 1e-4 chunked WKV against the step
    recurrence, 2e-4 decode against train);
  * prefill and decode logits at 1e-4 of max|logit| in float32, and at
    tests/test_serve.py's bfloat16 tolerances (rtol = atol = 3e-2,
    4e-2) in bfloat16 with the reference compiled with
    `xla_allow_excess_precision` off, as tests/test_torch_lm.py does;
  * packed 8-bit against the reference's XLA branch at 1e-4 of
    max|logit| (float32);
  * greedy tokens, admission counters, packed codes and cache layouts
    exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import CPU, n, np_tokens, shared_lm_models, t

from repro.configs.base import MoESpec as JMoESpec
from repro.models import moe as jmoe
from repro.models import rglru as jrg
from repro.models import rwkv6 as jrwkv
from repro.models import transformer as jT
from repro.serve import engine as jE
from repro_torch import configs as tconfigs
from repro_torch.configs.base import MoESpec as TMoESpec
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trg
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import transformer as tT
from repro_torch.serve import engine as tE

FAMILIES = ("olmoe_1b_7b", "llama4_scout_17b_a16e", "recurrentgemma_2b",
            "rwkv6_3b")
RECURRENT = ("recurrentgemma_2b", "rwkv6_3b")
BF16 = dict(rtol=3e-2, atol=3e-2)
BF16_DECODE = dict(rtol=4e-2, atol=4e-2)
F32_REL = 1e-4
MODULE_REL = 1e-5


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


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread, so that the
    suite's parallel workers do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t_tree(tree):
    return jax.tree.map(lambda a: t(np.asarray(a)), tree)


def normal(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# MoE (tests/test_moe.py)
# ---------------------------------------------------------------------------


def _moe_pair(seed, d, **spec):
    js, ts = JMoESpec(**spec), TMoESpec(**spec)
    pj = jmoe.moe_init(jax.random.PRNGKey(seed), d, js)
    return js, ts, pj, t_tree(np_tree(pj))


@pytest.mark.parametrize("topk", [1, 2])
def test_moe_matches_reference_and_per_token_loop(topk):
    """The dispatch (dropless at capacity S·k) against the reference's
    moe_apply and against a per-token loop, with the same aux loss."""
    js, ts, pj, pt = _moe_pair(0, 24, num_experts=4, top_k=topk,
                               d_ff_expert=16)
    x = normal(1, (2, 12, 24))
    yj, auxj = jax.jit(functools.partial(
        jmoe.moe_apply, spec=js, dtype=jnp.float32, capacity=12 * topk))(
            pj, jnp.asarray(x))
    yt, auxt = tmoe.moe_apply(pt, t(x), ts, dtype=torch.float32,
                              capacity=12 * topk)
    assert rel(n(yt), yj) <= MODULE_REL
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-6)
    # the per-token loop of tests/test_moe.py, in numpy
    probs = torch.softmax(t(x) @ pt["router"]["w"], -1)
    gates, eidx = tmoe.top_k(probs, topk)
    gates = gates / gates.sum(-1, keepdim=True)
    ref = np.zeros_like(x)
    for b in range(2):
        for s in range(12):
            for i in range(topk):
                e = int(eidx[b, s, i])
                tok = t(x[b, s])
                h = tmoe.silu(tok @ pt["w_gate"][e]) * (tok @ pt["w_up"][e])
                ref[b, s] += float(gates[b, s, i]) * n(h @ pt["w_down"][e])
    np.testing.assert_allclose(n(yt), ref, rtol=2e-3, atol=2e-3)


def test_positions_within_expert():
    """tests/test_moe.py's case, and random rows against the reference."""
    eidx = torch.tensor([[0, 1, 0, 0, 1, 2]])
    assert tmoe._positions_within_expert(eidx, 3)[0].tolist() == \
        [0, 0, 1, 2, 1, 0]
    rows = np.random.default_rng(2).integers(0, 5, (3, 40)).astype(np.int32)
    want = jmoe._positions_within_expert(jnp.asarray(rows), 5)
    got = tmoe._positions_within_expert(t(rows).long(), 5)
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_capacity_drops_tokens_like_the_reference():
    """Capacity 1: later duplicate-expert tokens drop (zero rows, adding
    nothing to the kept token in slot c-1), exactly the reference's."""
    js, ts, pj, pt = _moe_pair(2, 8, num_experts=2, top_k=1, d_ff_expert=8,
                               capacity_factor=0.01)
    x = normal(3, (1, 16, 8))
    yj, _ = jax.jit(functools.partial(
        jmoe.moe_apply, spec=js, dtype=jnp.float32, capacity=1))(
            pj, jnp.asarray(x))
    yt, _ = tmoe.moe_apply(pt, t(x), ts, dtype=torch.float32, capacity=1)
    assert rel(n(yt), yj) <= MODULE_REL
    nonzero = int((n(yt)[0] != 0).any(-1).sum())
    assert nonzero <= 2
    assert ((n(yt)[0] != 0).any(-1) == (np.asarray(yj)[0] != 0).any(-1)).all()


@pytest.mark.parametrize("name", ["olmoe_1b_7b", "llama4_scout_17b_a16e"])
def test_capacity_at_full_config_equals_the_reference(name):
    """C = ceil(S·k·cf / E) clipped to S·k, for prefill and decode lengths:
    olmoe's full CONFIG holds 3 a 16-token prefill and 1 a decode step."""
    spec = tconfigs.get(name).moe
    k, cf, e = spec.top_k, spec.capacity_factor, spec.num_experts
    for s in (1, 2, 5, 16, 64, 333):
        # the reference's expression (src/repro/models/moe.py:79-83)
        want = min(max(1, int(-(-s * k * cf // e))), s * k)
        assert tmoe.capacity_for(s, spec) == want
    if name == "olmoe_1b_7b":
        assert (tmoe.capacity_for(16, spec), tmoe.capacity_for(1, spec)) == \
            (3, 1)


def test_top_k_ties_break_to_the_lower_index():
    """`jax.lax.top_k` keeps the lower index first among equal values; so
    does the port's stable sort (a zero router gives all-equal probs)."""
    vals = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                     [0.3, 0.2, 0.3, 0.2]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(vals), k)
        tv, ti = tmoe.top_k(t(vals), k)
        np.testing.assert_array_equal(n(ti), np.asarray(ji))
        np.testing.assert_array_equal(n(tv), np.asarray(jv))


def test_aux_loss_uniform_router_equals_the_reference():
    """A zero router ties every expert: the aux loss equals the
    reference's (top-1 goes to expert 0 on both sides)."""
    js, ts, pj, pt = _moe_pair(6, 8, num_experts=4, top_k=1, d_ff_expert=8)
    pj["router"]["w"] = jnp.zeros_like(pj["router"]["w"])
    pt["router"]["w"] = torch.zeros_like(pt["router"]["w"])
    x = normal(7, (2, 64, 8))
    _, auxj = jax.jit(functools.partial(
        jmoe.moe_apply, spec=js, dtype=jnp.float32))(pj, jnp.asarray(x))
    _, auxt = tmoe.moe_apply(pt, t(x), ts, dtype=torch.float32)
    assert float(auxt) == pytest.approx(float(auxj), rel=1e-6)
    assert 0.9 < float(auxt) < 1.5


def test_shared_expert_added_and_grads_flow():
    """The shared expert changes the output; autograd reaches the router
    and every expert array (tests/test_moe.py's grads test)."""
    _, ts, _, pt = _moe_pair(4, 8, num_experts=2, top_k=1, d_ff_expert=8,
                             shared_expert_ff=8)
    assert "shared" in pt
    x = t(normal(5, (1, 4, 8)))
    y, _ = tmoe.moe_apply(pt, x, ts, dtype=torch.float32)
    p2 = dict(pt, shared={k: {"w": torch.zeros_like(v["w"])}
                          for k, v in pt["shared"].items()})
    y2, _ = tmoe.moe_apply(p2, x, ts, dtype=torch.float32)
    assert float((y - y2).abs().max()) > 1e-6
    _, ts, _, pt = _moe_pair(8, 8, num_experts=4, top_k=2, d_ff_expert=8)
    leaves = [pt["router"]["w"], pt["w_gate"], pt["w_up"], pt["w_down"]]
    for leaf in leaves:
        leaf.requires_grad_(True)
    y, aux = tmoe.moe_apply(pt, t(normal(9, (1, 8, 8))), ts,
                            dtype=torch.float32)
    (torch.sum(y ** 2) + 0.01 * aux).backward()
    for leaf in leaves:
        assert float(leaf.grad.abs().sum()) > 0


def test_gelu_and_sigmoid_equal_jax_bit_for_bit_in_bfloat16():
    """`layers.gelu` rounds its constants to the dtype, as XLA rounds a
    weakly typed constant (multiplying by the Python float 0.044715 at
    float32 flipped the last bit of about 1 in 400 outputs), and
    `layers.sigmoid` is XLA's 1 / (1 + exp(-x)): both equal `jax.nn`'s
    compiled with `xla_allow_excess_precision` off, bit for bit."""
    from repro_torch.models import layers as tL

    x = normal(11, (200_000,), 3.0)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = t(x).to(torch.bfloat16)
    for fj, ft in ((jax.nn.gelu, tL.gelu), (jax.nn.sigmoid, tL.sigmoid)):
        want = jax.jit(fj).lower(xj).compile(
            compiler_options={"xla_allow_excess_precision": False})(xj)
        np.testing.assert_array_equal(
            n(ft(xt).to(torch.float32)),
            np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# RWKV-6 and RG-LRU (tests/test_recurrent.py)
# ---------------------------------------------------------------------------


def _wkv_inputs(seed, b, s, h, hd):
    r, k, v = (normal(seed + i, (b, s, h, hd)) for i in range(3))
    lw = -np.exp(normal(seed + 3, (b, s, h, hd), 0.5))
    u = normal(seed + 4, (h, hd), 0.1)
    return r, k, v, lw, u, np.zeros((b, h, hd, hd), np.float32)


def test_wkv_chunked_matches_reference_and_step():
    arrays = _wkv_inputs(0, 2, 32, 2, 8)
    oj, sj = jax.jit(jrwkv.wkv_chunked)(*map(jnp.asarray, arrays))
    ot, st = trwkv.wkv_chunked(*map(t, arrays))
    assert rel(n(ot), oj) <= MODULE_REL and rel(n(st), sj) <= MODULE_REL
    r, k, v, lw, u, st0 = map(t, arrays)
    state, outs = st0, []
    for i in range(r.shape[1]):
        o, state = trwkv.wkv_step(r[:, i], k[:, i], v[:, i], lw[:, i], u, state)
        outs.append(o)
    np.testing.assert_allclose(n(torch.stack(outs, 1)), n(ot), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(n(state), n(st), rtol=1e-4, atol=1e-4)


def test_wkv_carries_state_across_calls():
    r, k, v, _, _, st0 = map(t, _wkv_inputs(1, 1, 32, 2, 8))
    lw = torch.full_like(r, -np.exp(-1.0))
    u = torch.zeros((2, 8))
    full, _ = trwkv.wkv_chunked(r, k, v, lw, u, st0)
    first, mid = trwkv.wkv_chunked(r[:, :16], k[:, :16], v[:, :16],
                                   lw[:, :16], u, st0)
    second, _ = trwkv.wkv_chunked(r[:, 16:], k[:, 16:], v[:, 16:],
                                  lw[:, 16:], u, mid)
    np.testing.assert_allclose(n(torch.cat([first, second], 1)), n(full),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s", [17, 20, 31, 40])
def test_wkv_refuses_an_unchunkable_length_where_the_reference_does(s):
    """More than one chunk that is not a whole number of 16-token chunks:
    the reference asserts, the port raises (no padding)."""
    arrays = _wkv_inputs(2, 1, s, 1, 4)
    with pytest.raises(AssertionError):
        jrwkv.wkv_chunked(*map(jnp.asarray, arrays))
    with pytest.raises(ValueError, match="whole number"):
        trwkv.wkv_chunked(*map(t, arrays))


def test_decay_clamp_keeps_chunks_finite():
    b, s, h, hd = 1, trwkv.CHUNK, 1, 4
    ones = torch.ones((b, s, h, hd))
    out, st = trwkv.wkv_chunked(ones, ones, ones, torch.full_like(ones, -4.0),
                                torch.zeros((h, hd)), torch.zeros((b, h, hd, hd)))
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(st).all())


def _perturbed_rwkv(d, f, hd):
    p = jrwkv.rwkv_init(jax.random.PRNGKey(2), d, f, hd)
    return jax.tree.map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(3), x.shape),
        p)


def test_rwkv_block_matches_reference_and_decode_equals_train():
    b, s, d, hd, f = 2, 16, 32, 8, 64
    pj = _perturbed_rwkv(d, f, hd)
    pt = t_tree(np_tree(pj))
    x = normal(4, (b, s, d))
    yj, cj = jax.jit(functools.partial(
        jrwkv.block_apply, head_dim=hd, dtype=jnp.float32))(pj, jnp.asarray(x))
    yt, ct = trwkv.block_apply(pt, t(x), hd, dtype=torch.float32)
    assert rel(n(yt), yj) <= MODULE_REL
    for key in ("tm_shift", "cm_shift", "state"):
        assert rel(n(ct[key]), cj[key]) <= MODULE_REL
    cache, outs = None, []
    for i in range(s):
        o, cache = trwkv.block_apply(pt, t(x[:, i:i + 1]), hd, cache=cache,
                                     dtype=torch.float32)
        outs.append(o)
    np.testing.assert_allclose(n(torch.cat(outs, 1)), n(yt), rtol=2e-4,
                               atol=2e-4)


def test_rglru_matches_reference_and_decode_equals_train():
    b, s, d, r = 2, 24, 32, 16
    pj = jrg.rglru_init(jax.random.PRNGKey(5), d, r)
    pt = t_tree(np_tree(pj))
    x = normal(6, (b, s, d))
    yj, cj = jax.jit(functools.partial(jrg.rglru_apply, dtype=jnp.float32))(
        pj, jnp.asarray(x))
    yt, ct = trg.rglru_apply(pt, t(x), dtype=torch.float32)
    assert rel(n(yt), yj) <= MODULE_REL
    assert rel(n(ct["h"]), cj["h"]) <= MODULE_REL
    assert rel(n(ct["conv"]), cj["conv"]) <= MODULE_REL
    cache, outs = None, []
    for i in range(s):
        o, cache = trg.rglru_apply(pt, t(x[:, i:i + 1]), cache=cache,
                                   dtype=torch.float32)
        outs.append(o)
    np.testing.assert_allclose(n(torch.cat(outs, 1)), n(yt), rtol=2e-4,
                               atol=2e-4)


def test_rglru_state_bounded():
    """|a_t| < 1 by construction: the state stays bounded over 512 steps
    of large inputs (the port's float32 loop as the reference's scan)."""
    pt = trg.rglru_init(torch.Generator().manual_seed(7), 16, 8)
    y, cache = trg.rglru_apply(pt, t(normal(8, (1, 512, 16), 5.0)),
                               dtype=torch.float32)
    assert bool(torch.isfinite(y).all())
    assert float(cache["h"].abs().max()) < 1e3


def test_init_shapes_and_dtypes_equal_the_reference():
    """The port's own inits (drawn from a torch.Generator) give the
    reference's param trees leaf for leaf: names, shapes, float32."""
    gen = torch.Generator().manual_seed(0)
    spec = dict(num_experts=4, top_k=2, d_ff_expert=8, shared_expert_ff=8)
    pairs = (
        (jmoe.moe_init(jax.random.PRNGKey(0), 16, JMoESpec(**spec)),
         tmoe.moe_init(gen, 16, TMoESpec(**spec))),
        (jrg.rglru_init(jax.random.PRNGKey(0), 16, 8),
         trg.rglru_init(gen, 16, 8)),
        (jrwkv.rwkv_init(jax.random.PRNGKey(0), 32, 48, 8),
         trwkv.rwkv_init(gen, 32, 48, 8)),
    )
    for pj, pt in pairs:
        assert _layout(pt) == _layout(pj)


# ---------------------------------------------------------------------------
# The decoder stack of the four reduced configs
# ---------------------------------------------------------------------------


def _layout(tree) -> dict:
    """{path: (shape, dtype name)} of every leaf, for either package."""
    return {
        "/".join(str(k.key) for k in kp): (
            tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
        for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


S, B, NEW = 12, 2, 3


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_match_reference(name, dtype):
    """The same weights and tokens through both packages: the prefill's
    last logits and cache, then NEW decode steps (the port updating its
    cache in place, recurrent states included), and the teacher-forced
    forward with the MoE aux loss."""
    mj, mt, pj, pt = shared_lm_models(name, dtype)
    allt = np_tokens((B, S + NEW), mt.cfg.vocab, seed=1)

    def ref(fn, *args):
        return compiled(fn, dtype, *args)(*args)

    def check(got, want, tol):
        if dtype == "float32":
            assert rel(n(got), want) <= F32_REL
        else:
            np.testing.assert_allclose(n(got), np.asarray(want), **tol)

    lj, cj = ref(mj.prefill, pj, jnp.asarray(allt[:, :S]))
    lt, ct = mt.prefill(pt, t(allt[:, :S]).long())
    assert lt.dtype == torch.float32 and lt.shape == (B, mt.dims.vocab)
    check(lt, lj, BF16)
    assert _layout(ct) == _layout(cj)
    for step in range(NEW):
        pos = np.full((B,), S + step, np.int32)
        lj, cj = ref(mj.decode_step, pj, cj, jnp.asarray(allt[:, S + step]),
                     jnp.asarray(pos))
        lt, ct2 = mt.decode_step(pt, ct, t(allt[:, S + step]).long(),
                                 t(pos).long())
        assert ct2 is ct  # updated in place
        check(lt, lj, BF16_DECODE)
    full_j, aux_j = ref(lambda p, x: jT.forward_train(p, x, mj.cfg, mj.dims),
                        pj, jnp.asarray(allt))
    full_t, aux_t = tT.forward_train(pt, t(allt).long(), mt.cfg, mt.dims)
    check(full_t, full_j, BF16)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_matches_teacher_forced(name):
    """tests/test_serve.py's check on the port alone, in the configs'
    bfloat16: the prefill's last logits and each decode step against the
    teacher-forced forward at the same position. The reduced MoE configs
    are dropless (capacity factor 8), so decode equals train there."""
    _, mt, _, pt = shared_lm_models(name, "bfloat16")
    allt = t(np_tokens((B, S + NEW), mt.cfg.vocab, seed=2)).long()
    last, cache = mt.prefill(pt, allt[:, :S])
    full, _ = tT.forward_train(pt, allt, mt.cfg, mt.dims)
    np.testing.assert_allclose(n(last), n(full[:, S - 1]), **BF16)
    for i in range(NEW):
        pos = torch.full((B,), S + i, dtype=torch.long)
        lg, cache = mt.decode_step(pt, cache, allt[:, S + i], pos)
        np.testing.assert_allclose(n(lg), n(full[:, S + i]), **BF16_DECODE)


def test_init_cache_layout_equals_the_reference():
    """`init_cache` leaf for leaf as the reference's (path, shape, dtype):
    recurrent `h` and `state` float32, the shifts and conv taps in the
    compute dtype, so seating finds the slot axis where it expects it."""
    for name in FAMILIES:
        for dtype in ("bfloat16", "float32"):
            mj, mt, _, _ = shared_lm_models(name, dtype)
            assert _layout(mt.init_cache(3, device=CPU)) == \
                _layout(mj.init_cache(3)), (name, dtype)


@pytest.mark.parametrize("name", FAMILIES)
def test_quantize_for_serving_tree_equals_the_reference(name):
    """Exactly the reference's leaves are packed, with its codes: the
    projections (the recurrent ones too, and llama4's shared expert); the
    MoE router and bare expert arrays, RG-LRU's w_a / w_i and rwkv's
    adapters stay dense and shared with the master tree."""
    _, _, pj, pt = shared_lm_models(name, "float32")
    qj = jE.quantize_for_serving(pj, 8)
    qt = tE.quantize_for_serving(pt, 8)
    assert _layout(qt) == _layout(qj)
    for kp, leaf in jax.tree_util.tree_flatten_with_path(qj)[0]:
        node = qt
        for k in kp:
            node = node[k.key]
        if kp[-1].key == "scale" and kp[-2].key.startswith("w"):
            np.testing.assert_allclose(n(node), np.asarray(leaf), rtol=1e-6)
        else:
            np.testing.assert_array_equal(n(node), np.asarray(leaf))
    blk = qt["blocks"]["pos0"]
    if "moe" in blk:
        for k in ("w_gate", "w_up", "w_down"):
            assert blk["moe"][k] is pt["blocks"]["pos0"]["moe"][k]
        assert "w" in blk["moe"]["router"]
    if "mix" in blk and "w_a" in blk["mix"]:
        assert "w" in blk["mix"]["w_a"] and "w" in blk["mix"]["w_i"]
        assert "packed" in blk["mix"]["w_x"] and "packed" in blk["mix"]["w_out"]
    if "rwkv" in blk:
        assert "packed" in blk["rwkv"]["w_r"] and "packed" in blk["rwkv"]["cm_k"]
        assert blk["rwkv"]["lora_a"] is pt["blocks"]["pos0"]["rwkv"]["lora_a"]


@pytest.mark.parametrize("name", FAMILIES)
def test_packed_8bit_matches_reference(name):
    """The packed tree (ops.quant_matmul's plain version here) against the
    reference's packed XLA branch: prefill and decode logits, float32."""
    mj, mt, pj, pt = shared_lm_models(name, "float32")
    qj, qt = jE.quantize_for_serving(pj, 8), tE.quantize_for_serving(pt, 8)
    allt = np_tokens((B, S + NEW), mt.cfg.vocab, seed=3)
    args = (qj, jnp.asarray(allt[:, :S]))
    lj, cj = compiled(mj.prefill, "float32", *args)(*args)
    lt, ct = mt.prefill(qt, t(allt[:, :S]).long())
    assert rel(n(lt), lj) <= F32_REL
    for step in range(NEW):
        pos = np.full((B,), S + step, np.int32)
        args = (qj, cj, jnp.asarray(allt[:, S + step]), jnp.asarray(pos))
        lj, cj = compiled(mj.decode_step, "float32", *args)(*args)
        lt, ct = mt.decode_step(qt, ct, t(allt[:, S + step]).long(),
                                t(pos).long())
        assert rel(n(lt), lj) <= F32_REL


@pytest.mark.parametrize("name", FAMILIES)
def test_generate_greedy_matches_reference(name):
    """Greedy tokens identical to the reference's in float32, dense and
    packed at 8 bits."""
    mj, mt, pj, pt = shared_lm_models(name, "float32")
    prompts = np_tokens((2, 8), mt.cfg.vocab, seed=4)
    for bits in (None, 8):
        pjb = jE.quantize_for_serving(pj, bits) if bits else pj
        ptb = tE.quantize_for_serving(pt, bits) if bits else pt
        want = jE.generate(mj, pjb, jnp.asarray(prompts), max_new=6)
        got = tE.generate(mt, ptb, t(prompts), max_new=6, device=CPU)
        np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("name", RECURRENT + ("olmoe_1b_7b",))
def test_engine_burst_matches_reference(name):
    """Co-seated tenants at batch_size 3 (recurrent rows re-fed while idle,
    then overwritten by seating): every request's tokens equal the
    reference engine's, and the admission counters too."""
    mj, mt, pj, pt = shared_lm_models(name, "float32")
    lens = (4, 4, 7, 7, 5, 4)
    prompts = [np_tokens((s,), mt.cfg.vocab, 10 + i) for i, s in enumerate(lens)]
    je = jE.Engine(mj, pj, batch_size=3)
    te = tE.Engine(mt, pt, batch_size=3, device=CPU)
    jr = [jE.Request(uid=i, prompt=jnp.asarray(p), max_new=5)
          for i, p in enumerate(prompts)]
    tr = [tE.Request(uid=i, prompt=t(p), max_new=5)
          for i, p in enumerate(prompts)]
    for a, b in zip(jr, tr):
        je.submit(a)
        te.submit(b)
    je.run(max_ticks=60)
    te.run(max_ticks=60)
    assert [r.output for r in tr] == [r.output for r in jr]
    assert (te.admission_prefills, te.admission_rowsteps) == \
        (je.admission_prefills, je.admission_rowsteps)
    for p, r in zip(prompts, tr):
        solo = tE.generate(mt, pt, t(p)[None], max_new=5, device=CPU)
        assert n(solo)[0].tolist() == r.output


def test_rwkv_stack_refuses_an_unchunkable_prompt():
    """A 20-token prompt to rwkv6: the reference's prefill asserts, the
    port's raises; 16 and 32 tokens run on both."""
    mj, mt, pj, pt = shared_lm_models("rwkv6_3b", "float32")
    for s_len, ok in ((20, False), (16, True), (32, True)):
        toks = np_tokens((1, s_len), mt.cfg.vocab, seed=s_len)
        if ok:
            lj, _ = mj.prefill(pj, jnp.asarray(toks))
            lt, _ = mt.prefill(pt, t(toks).long())
            assert rel(n(lt), lj) <= F32_REL
            continue
        with pytest.raises(AssertionError):
            mj.prefill(pj, jnp.asarray(toks))
        with pytest.raises(ValueError, match="whole number"):
            mt.prefill(pt, t(toks).long())


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "recurrentgemma-2b",
                                  "rwkv6-3b"])
def test_launch_serve_reduced_families_on_the_cpu(arch):
    """`launch.serve.main --reduced` for the new families, dense and 8-bit:
    the tokens equal generate on the same build."""
    from repro_torch.launch import serve as tlaunch

    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8",
            "--max-new", "4", "--quant-bits", "8"]
    rec = tlaunch.main(argv, device="cpu")
    args = tlaunch.main.__globals__["argparse"].Namespace(
        arch=arch, reduced=True, batch=2, prompt_len=8, max_new=4,
        quant_bits=8, seed=0)
    _, model, params, prompts = tlaunch.build_lm(args, device="cpu")
    want = tE.generate(model, params, prompts, max_new=4, device=CPU)
    assert rec["tokens"] == want.tolist()

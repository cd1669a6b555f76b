"""PyTorch port vs JAX package: LM training — the synthetic token stream,
`loss_fn` (plain, chunked CE, block remat, the paper's QAT) for every
family, one train step and an 8-step run from the reference's state, the
donated (in-place) step, micro-batch accumulation, `launch.train` and a
kill-and-resume through `fault.run_training`.

Same numpy inputs (and the JAX stream's batches, as numpy: torch cannot
reproduce `jax.random`) through `repro` and `repro_torch`, on the CPU, in
float32 (bfloat16 flips compound over layers; tests/test_torch_lm.py).
Tolerances, each for its reason:

- the token assembly, the donated step against the functional one, remat
  against none, a resumed run against an uninterrupted one: bit for bit
  (the same ops in the same order);
- a loss: 1e-5 relative; gradients: 1e-4 in tree-relative L1 —
  float32 matmuls and softmaxes that sum in another order (XLA's against
  PyTorch's);
- one train step from warm moments: 1e-5 relative to each tree's max
  (the VA trainer's, tests/test_torch_train.py); an 8-step run: 1e-3 on
  each step's loss (order-level differences compound through Adam);
- micro-batches against the full batch: the reference's 0.02
  (tests/test_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import CPU, lm_models, n, np_tokens, shared_lm_models, t

from repro import configs as jconfigs
from repro import optim as jopt
from repro.data import lm as jlm
from repro.train import trainer as jtrainer
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch._tree import leaves, tree_map
from repro_torch.data import lm as tlm
from repro_torch.dist import accumulate as tacc
from repro_torch.launch import train as tlaunch
from repro_torch.models import api as tapi
from repro_torch.train import fault
from repro_torch.train import trainer as ttrainer

LOSS_RTOL = 1e-5
GRAD_L1 = 1e-4
STEP_RTOL = 1e-5
B, S = 2, 16


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread, so that the
    suite's parallel workers do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_batch(cfg, seed: int = 1, batch: int = B, seq: int = S) -> dict:
    tok = np_tokens((batch, seq + 1), cfg.vocab, seed)
    b = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    if cfg.is_enc_dec:
        rng = np.random.default_rng(seed + 100)
        b["frames"] = rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return b


def _tb(b: dict) -> dict:
    return {k: t(v) for k, v in b.items()}


def _jb(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t_loss_grads(model, params, batch):
    """(loss, grads tree) of the port, as the trainer takes them."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = model.loss(live, batch)
    grads = torch.autograd.grad(loss, leaves(live), allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), live)


def _j_loss_grads(model, params, batch):
    (loss, _), g = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        params, batch)
    return loss, g


def _pairs(got, want) -> list:
    """(port leaf, reference leaf) at every place of the port's tree; the
    reference's dicts are read by key."""
    out = []
    tree_map(lambda g, w: out.append((n(g), n(w))), got, want)
    return out


def _l1(got, want) -> float:
    """sum |got - want| / sum |want| over a whole tree."""
    pairs = _pairs(got, want)
    return (sum(float(np.abs(g - w).sum()) for g, w in pairs)
            / sum(float(np.abs(w).sum()) for _, w in pairs))


def _rel(got, want) -> float:
    """max |got - want| / max |want| over a whole tree."""
    pairs = _pairs(got, want)
    return (max(float(np.abs(g - w).max()) for g, w in pairs)
            / max(float(np.abs(w).max()) for _, w in pairs))


def _check_loss_and_grads(mj, mt, pj, pt, b):
    lt, gt = _t_loss_grads(mt, pt, _tb(b))
    lj, gj = _j_loss_grads(mj, pj, _jb(b))
    assert float(lt) == pytest.approx(float(lj), rel=LOSS_RTOL)
    assert _l1(gt, gj) <= GRAD_L1
    return lt, gt


def _equal_trees(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


# ---------------------------------------------------------------------------
# (a) the token stream
# ---------------------------------------------------------------------------


def test_walk_assembly_matches_the_reference_on_its_draws():
    """The reference's `synth_tokens` against the port's assembly of the
    same draws (the reference's own, taken from its key as it takes them),
    exactly; and floor-mod on a walk that goes negative."""
    vocab, key = 1000, jax.random.PRNGKey(3)
    want = np.asarray(jlm.synth_tokens(key, 4, 33, vocab))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = {
        "steps": jax.random.randint(k1, (4, 33), -8, 9),
        "start": jax.random.randint(k2, (4, 1), 0, vocab),
        "noise": jax.random.randint(k3, (4, 33), 0, vocab),
        "is_noise": jax.random.bernoulli(k4, 0.05, (4, 33)),
    }
    got = tlm.assemble_walk(**{k: t(np.asarray(v)) for k, v in draws.items()},
                            vocab=vocab)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), want)
    down = np.full((2, 40), -8, np.int32)
    start = np.array([[3], [0]], np.int32)
    walk = tlm.assemble_walk(t(down), t(start), t(down),
                             t(np.zeros((2, 40), bool)), vocab=50)
    np.testing.assert_array_equal(
        n(walk), (start + np.cumsum(down, axis=1)) % 50)
    assert int(walk.min()) >= 0


def test_token_stream_schema_determinism_and_structure():
    """Mirrors tests/test_data.py's LM stream tests on the port's own
    draws: shapes, range, next-token alignment, per-seed and per-host
    determinism, and a walk a model can learn."""
    b = tlm.batch_at(0, 7, batch=4, seq_len=32, vocab=1000, device=CPU)
    assert b["tokens"].shape == b["targets"].shape == (4, 32)
    assert b["tokens"].dtype == torch.int32
    assert 0 <= int(b["tokens"].min()) and int(b["tokens"].max()) < 1000
    torch.testing.assert_close(b["tokens"][:, 1:], b["targets"][:, :-1],
                               rtol=0, atol=0)
    s0 = tlm.TokenStream(batch=4, seq_len=32, vocab=1000, seed=3, device=CPU)
    s0b = tlm.TokenStream(batch=4, seq_len=32, vocab=1000, seed=3, device=CPU)
    s1 = tlm.TokenStream(batch=4, seq_len=32, vocab=1000, seed=3, host_id=1,
                         device=CPU)
    s2 = tlm.TokenStream(batch=4, seq_len=32, vocab=1000, seed=4, device=CPU)
    assert torch.equal(s0.batch_at(5)["tokens"], s0b.batch_at(5)["tokens"])
    assert not torch.equal(s0.batch_at(5)["tokens"], s1.batch_at(5)["tokens"])
    assert not torch.equal(s0.batch_at(5)["tokens"], s2.batch_at(5)["tokens"])
    assert not torch.equal(s0.batch_at(5)["tokens"], s0.batch_at(6)["tokens"])
    assert torch.equal(next(iter(s0))["tokens"], s0.batch_at(0)["tokens"])
    big = tlm.batch_at(0, 0, batch=64, seq_len=128, vocab=1000, device=CPU)
    tok, tgt = n(big["tokens"]).astype(int), n(big["targets"]).astype(int)
    diff = np.minimum((tgt - tok) % 1000, (tok - tgt) % 1000)
    assert np.median(diff) <= 8
    # a noise token breaks the step into it and the step out of it:
    # 1 - 0.95^2 = 9.75% of the pairs (a few of those land within 8)
    noise_share = float(np.mean(diff > 8))
    assert 0.07 < noise_share < 0.12


# ---------------------------------------------------------------------------
# (b)-(e) loss_fn and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", jconfigs.ALL_ARCHS)
def test_loss_and_grads_match_jax(name):
    """`model.loss` and its gradients for every family (whisper with
    frames) against `jax.value_and_grad(model.loss, has_aux=True)`."""
    mj, mt, pj, pt = shared_lm_models(name, "float32")
    b = _np_batch(mt.cfg)
    _check_loss_and_grads(mj, mt, pj, pt, b)
    _, met = mt.loss(pt, _tb(b))
    assert set(met) >= {"loss", "nll"}
    if mt.cfg.moe is not None:
        assert float(met["moe_aux"]) > 0.0


@pytest.mark.parametrize("name", ["qwen3_8b", "recurrentgemma_2b"])
@pytest.mark.parametrize("spe", [{"spe_bits": 8, "spe_sparse": True},
                                 {"spe_bits": 4}], ids=["8bit_sparse", "4bit"])
def test_qat_loss_and_grads_match_jax(name, spe):
    """The paper's co-design QAT on every projection (16:8 prune-STE and
    fake-quant; straight-through backward, under block remat)."""
    mj, mt, pj, pt = lm_models(name, "float32", max_seq=40, **spe)
    _check_loss_and_grads(mj, mt, pj, pt, _np_batch(mt.cfg, seed=2))


@pytest.mark.parametrize("chunk", [4, 5, 16])
def test_chunked_ce_matches_plain_and_the_reference(chunk):
    """`loss_chunk` (5 pads S = 16 to 20 and masks the pad): equal to the
    unchunked CE and to the reference's chunked one, gradients too
    (mirrors tests/test_perf_features.py)."""
    mj, mt, pj, pt = lm_models("qwen3_8b", "float32", max_seq=40,
                               loss_chunk=chunk)
    b = _np_batch(mt.cfg, seed=3)
    lt, gt = _check_loss_and_grads(mj, mt, pj, pt, b)
    plain = tapi.build_model(dataclasses.replace(mt.cfg, loss_chunk=0),
                             max_seq=40)
    lp, gp = _t_loss_grads(plain, pt, _tb(b))
    assert float(lt) == pytest.approx(float(lp), rel=LOSS_RTOL)
    assert _l1(gt, gp) <= GRAD_L1


@pytest.mark.parametrize("name,spe", [
    ("qwen3_8b", {}),
    ("recurrentgemma_2b", {"spe_bits": 8, "spe_sparse": True}),
    ("olmoe_1b_7b", {}),
], ids=["qwen3", "recurrentgemma_qat", "olmoe"])
def test_block_remat_equals_no_remat(name, spe):
    """`remat="block"` (each pattern group under checkpoint, recomputed in
    the backward) against `"none"`: the same ops again, so bit for bit on
    the CPU — through the STE functions and the MoE router too."""
    cfg = dataclasses.replace(tconfigs.reduced(name), dtype="float32", **spe)
    assert cfg.remat == "block"
    block = tapi.build_model(cfg, max_seq=40)
    none = tapi.build_model(dataclasses.replace(cfg, remat="none"), max_seq=40)
    pt = block.init(0, device=CPU)
    b = _tb(_np_batch(cfg, seed=4))
    l1, g1 = _t_loss_grads(block, pt, b)
    l0, g0 = _t_loss_grads(none, pt, b)
    assert torch.equal(l1, l0)
    assert _equal_trees(g1, g0)


# ---------------------------------------------------------------------------
# (f)-(h) the train step
# ---------------------------------------------------------------------------


def _schedule(o):
    return o.linear_warmup_cosine(3e-3, 2, 20)


def _warm_reference(name: str, steps: int = 3):
    """The reference's model, jitted AdamW step and its state after
    `steps` steps on its own stream (batch 4, seq 16)."""
    mj, mt, pj, _ = shared_lm_models(name, "float32")
    opt_j = jopt.adamw(_schedule(jopt), weight_decay=0.01)
    step_j = jax.jit(jtrainer.make_train_step(mj.loss, opt_j, clip_norm=1.0))
    stream = jlm.TokenStream(batch=4, seq_len=S, vocab=mj.cfg.vocab, seed=0)
    state_j = jtrainer.init_state(pj, opt_j)
    for i in range(steps):
        state_j, _ = step_j(state_j, stream.batch_at(i))
    return mt, step_j, stream, state_j


def _np_stream_batch(stream, i: int) -> dict:
    return {k: np.asarray(v) for k, v in stream.batch_at(i).items()}


def test_train_step_and_eight_steps_from_the_reference_state():
    """The reference's warm state (3 steps) carried across by
    `lm_state_from_numpy`; one step of both on the same batch — params, m
    and v within 1e-5 — then 8 more of both on the reference's batches,
    each loss within 1e-3."""
    mt, step_j, stream, state_j = _warm_reference("qwen3_8b")
    state_t = convert.lm_state_from_numpy(jax.tree.map(np.asarray, state_j),
                                          CPU)
    assert int(state_t["step"]) == 3 and state_t["step"].dtype == torch.int32
    opt_t = topt.adamw(_schedule(topt), weight_decay=0.01)
    step_t = ttrainer.make_train_step(mt.loss, opt_t, clip_norm=1.0)
    b = _np_stream_batch(stream, 3)
    new_t, m_t = step_t(state_t, _tb(b))
    new_j, m_j = step_j(state_j, _jb(b))
    assert float(m_t["loss"]) == pytest.approx(float(m_j["loss"]),
                                               rel=STEP_RTOL)
    assert float(m_t["grad_norm"]) == pytest.approx(float(m_j["grad_norm"]),
                                                    rel=1e-4)
    assert int(new_t["step"]) == int(new_j["step"]) == 4
    assert _rel(new_t["params"], new_j["params"]) <= STEP_RTOL
    for k in ("m", "v"):
        assert _rel(new_t["opt"][k], new_j["opt"][k]) <= STEP_RTOL
    state_t, state_j = new_t, new_j
    for i in range(4, 12):
        b = _np_stream_batch(stream, i)
        state_j, m_j = step_j(state_j, _jb(b))
        state_t, m_t = step_t(state_t, _tb(b))
        assert abs(float(m_t["loss"]) - float(m_j["loss"])) <= 1e-3, i


_OPTS = {
    "adamw": lambda: topt.adamw(_schedule(topt), weight_decay=0.01),
    "adam": lambda: topt.adam(3e-3),
    "sgd": lambda: topt.sgd(0.1),
    "momentum": lambda: topt.sgd(0.1, momentum=0.9),
    "nesterov": lambda: topt.sgd(0.1, momentum=0.9, nesterov=True),
}


@pytest.mark.parametrize("opt_name", list(_OPTS))
def test_donated_step_equals_the_functional_step_in_place(opt_name):
    """Two donated steps (the second reads the moments the first wrote)
    against two functional ones: equal bit for bit — every in-place op
    keeps the functional order — and every state tensor keeps its
    storage; the step returns the state it was given."""
    cfg = dataclasses.replace(tconfigs.reduced("qwen3_8b"), dtype="float32")
    model = tapi.build_model(cfg, max_seq=40)
    opt = _OPTS[opt_name]()
    fresh = lambda: ttrainer.init_state(model.init(0, device=CPU), opt,  # noqa: E731
                                        device=CPU)
    functional = ttrainer.make_train_step(model.loss, opt, clip_norm=1.0)
    donated = ttrainer.make_train_step(model.loss, opt, clip_norm=1.0,
                                       donate=True)
    state_f, state_d = fresh(), fresh()
    ptrs = [x.data_ptr() for x in leaves(state_d) if x is not None]
    for i in range(2):
        b = _tb(_np_batch(cfg, seed=10 + i, batch=4))
        state_f, m_f = functional(state_f, b)
        out, m_d = donated(state_d, b)
        assert out is state_d
        assert torch.equal(m_d["loss"], m_f["loss"])
        assert torch.equal(m_d["grad_norm"], m_f["grad_norm"])
    assert [x.data_ptr() for x in leaves(state_d) if x is not None] == ptrs
    assert int(state_d["step"]) == 2
    assert _equal_trees(state_d["params"], state_f["params"])
    for k, sub in state_f["opt"].items():
        if sub is not None:
            assert _equal_trees(state_d["opt"][k], sub)


@pytest.mark.parametrize("loss", ["shared", "expanded"])
def test_donated_step_with_aliased_gradients(loss):
    """autograd hands `a` and `b` of `sum((a + b) * x)` one gradient
    buffer, and of `sum(a + b)` an expanded (stride 0) one: the donated
    step copies them apart before it uses them as scratch, and still
    equals the functional step."""
    x = torch.arange(1.0, 4.0)
    fn = {"shared": lambda p, b: torch.sum((p["a"] + p["b"]) * b),
          "expanded": lambda p, b: torch.sum(p["a"] + p["b"]) * b.sum()}[loss]
    opt = topt.adamw(3e-3, weight_decay=0.01)
    step = lambda donate: ttrainer.make_train_step(  # noqa: E731
        lambda p, b: (fn(p, b), {}), opt, clip_norm=0, donate=donate)
    fresh = lambda: ttrainer.init_state(  # noqa: E731
        {"a": torch.ones(3), "b": torch.full((3,), 2.0)}, opt, device=CPU)
    want, got = fresh(), fresh()
    for _ in range(2):
        want, _ = step(False)(want, x)
        got, _ = step(True)(got, x)
    assert _equal_trees(got, want)
    assert not torch.equal(got["params"]["a"], torch.ones(3))


def test_micro_batches_match_the_full_batch():
    """n_micro=4 gradients against n_micro=1 on one batch of 8, within the
    reference's 0.02 (tests/test_train.py), and against the reference's
    n_micro=4."""
    from repro.dist.accumulate import accumulate_grads as jacc

    mj, mt, pj, pt = shared_lm_models("qwen3_8b", "float32")
    b = _np_stream_batch(jlm.TokenStream(batch=8, seq_len=S,
                                         vocab=mt.cfg.vocab), 0)

    def gf(p, mb):
        return _t_loss_grads(mt, p, mb)[1], {}

    def gf_j(p, mb):
        (_, m), g = jax.value_and_grad(mj.loss, has_aux=True)(p, mb)
        return g, m

    g1, _ = tacc.accumulate_grads(gf, pt, _tb(b), 1)
    g4, _ = tacc.accumulate_grads(gf, pt, _tb(b), 4)
    g4j, _ = jax.jit(lambda p, x: jacc(gf_j, p, x, 4))(pj, _jb(b))
    assert _l1(g4, tree_map(n, g1)) < 0.02
    assert _l1(g4, g4j) <= GRAD_L1


# ---------------------------------------------------------------------------
# (i)-(j) launch.train and kill-and-resume
# ---------------------------------------------------------------------------


def test_launch_train_lm_loss_falls():
    """The reference's CPU recipe (verify notes): the reduced qwen3-8b, 8
    steps at batch 8, seq 32, two micro-batches. Each batch's loss under
    the trained params is below its loss under the initial ones (drawn
    again from --seed); the step is donated, so the returned state is the
    one the run started from, updated in place."""
    argv = ["--arch", "qwen3-8b", "--reduced", "--steps", "8", "--batch",
            "8", "--seq", "32", "--grad-accum", "2", "--log-every", "0"]
    out = tlaunch.main(argv, device="cpu")
    assert len(out["history"]) == 8 and int(out["state"]["step"]) == 8
    model = tapi.build_model(tconfigs.reduced("qwen3-8b"), max_seq=32)
    p0 = model.init(0, device=CPU)
    with torch.no_grad():
        for i in (0, 7):
            b = out["batch_at"](i)
            before = float(model.loss(p0, b)[0])
            after = float(model.loss(out["state"]["params"], b)[0])
            assert after < before - 0.1, (i, before, after)


def test_launch_train_va_and_the_refused_flags():
    out = tlaunch.main(["--arch", "va-cnn", "--steps", "3", "--batch", "8",
                        "--log-every", "0"], device="cpu")
    assert len(out["history"]) == 3
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    # --multi-pod, --scheme and --no-compress are ported
    # (test_torch_multipod.py), the in-pod axes for every LM family too
    # (test_torch_inpod_train.py, test_torch_inpod_families.py); va-cnn
    # still refuses them
    with pytest.raises(SystemExit, match="va-cnn"):
        tlaunch.main(["--arch", "va-cnn", "--multi-pod", "1x2x2"],
                     device="cpu")


class _Kill(BaseException):
    """A kill: not an Exception, so `run_training` does not retry it."""


def test_lm_kill_and_resume_reproduces_the_uninterrupted_run(tmp_path):
    """A donated LM run through `fault.run_training` killed before step 5
    (checkpoints every 2 steps, one injected fault at step 3 replayed from
    step 2 on the way), then a fresh process-equivalent run on the same
    directory: it resumes from step 4 and ends bit for bit where an
    uninterrupted run ends."""
    cfg = dataclasses.replace(tconfigs.reduced("recurrentgemma_2b"),
                              dtype="float32")
    model = tapi.build_model(cfg, max_seq=S)
    opt = topt.adamw(_schedule(topt), weight_decay=0.01)
    step = ttrainer.make_train_step(model.loss, opt, clip_norm=1.0,
                                    donate=True)
    stream = tlm.TokenStream(batch=4, seq_len=S, vocab=cfg.vocab, seed=0,
                             device=CPU)

    def fresh():
        return ttrainer.init_state(model.init(0, device=CPU), opt, device=CPU)

    def run(ckpt_dir, hook=None):
        return fault.run_training(step, fresh(), stream.batch_at,
                                  num_steps=8, ckpt_dir=str(ckpt_dir),
                                  ckpt_every=2, fault_hook=hook, log_every=0)

    whole, hist_whole = run(tmp_path / "whole")
    faults = fault.FaultInjector({3})

    def hook(s):
        faults(s)
        if s == 5:
            raise _Kill()

    with pytest.raises(_Kill):
        run(tmp_path / "killed", hook)
    assert faults.failures == 1
    resumed, hist = run(tmp_path / "killed")
    assert [h["step"] for h in hist] == [4, 5, 6, 7]
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist_whole[4:]]
    assert int(resumed["step"]) == 8
    assert _equal_trees(resumed, whole)

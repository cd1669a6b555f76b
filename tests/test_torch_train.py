"""PyTorch port vs JAX package: VA co-design training — optimizers,
schedules, clipping, gradient accumulation, the loss, the train step, the
training stream and the quickstart.

Same numpy inputs (and the JAX stream's batches, as numpy: torch cannot
reproduce `jax.random`) through `repro` and `repro_torch`, on the CPU.
Tolerances, each for its reason:

- optimizer updates, schedules, clipping: 1e-6 — elementwise float32
  arithmetic in the same order;
- gradients, losses and one train step: 1e-5 relative — float32
  convolutions that sum in another order (XLA's against PyTorch's);
- a 20-step run: 1e-3 absolute on each step's loss — the order-level
  differences of each step compound through Adam, and a weight that moves
  across a fake-quant rounding boundary changes the forward by one
  quantization step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import CPU, NARROW, n, np_params, t

from repro import optim as jopt
from repro.configs import va_cnn as jcfgs
from repro.core import sparsity as JS
from repro.core import spe as jspe
from repro.core import vadetect as jva
from repro.data import iegm as jiegm
from repro.dist import accumulate as jacc
from repro.train import trainer as jtrainer
from repro_torch import convert, optim as topt
from repro_torch._tree import leaves, tree_map
from repro_torch.configs import va_cnn as tcfgs
from repro_torch.core import sparsity as TS
from repro_torch.core import spe as tspe
from repro_torch.core import vadetect as tva
from repro_torch.data import iegm as tiegm
from repro_torch.dist import accumulate as tacc
from repro_torch.examples import quickstart
from repro_torch.train import trainer as ttrainer

OPT_TOL = 1e-6
STEP_RTOL = 1e-5


def _np_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "conv0": {"w": rng.standard_normal((3, 4, 5)).astype(np.float32),
                  "b": rng.standard_normal((5,)).astype(np.float32)},
        "conv1": {"w": rng.standard_normal((6, 2)).astype(np.float32),
                  "b": rng.standard_normal((2,)).astype(np.float32)},
    }


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ttree(tree):
    return tree_map(lambda a: t(a), tree)


def _pairs(got, want) -> list:
    """(port leaf, reference leaf) at every place of the port's tree; the
    reference's dicts are read by key (its leaves are sorted by key)."""
    out = []
    tree_map(lambda g, w: out.append((n(g), n(w))), got, want)
    return out


def _close(got, want, rtol, atol=0.0, what=""):
    for g, w in _pairs(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def _rel(got, want) -> float:
    """max |got - want| / max |want| over a whole tree."""
    pairs = _pairs(got, want)
    err = max(float(np.abs(g - w).max()) for g, w in pairs)
    return err / max(float(np.abs(w).max()) for _, w in pairs)


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sgd", "momentum", "nesterov", "adam",
                                  "adamw", "adamw_mask"])
def test_optimizer_updates_match_jax(name):
    """Two updates from the initial state (the second reads the moments
    the first wrote), each against the reference's."""
    make = {
        "sgd": lambda o: o.sgd(0.1),
        "momentum": lambda o: o.sgd(0.1, momentum=0.9),
        "nesterov": lambda o: o.sgd(0.1, momentum=0.9, nesterov=True),
        "adam": lambda o: o.adam(3e-3),
        "adamw": lambda o: o.adamw(3e-3, weight_decay=0.1),
    }
    if name == "adamw_mask":
        # decay every parameter but the biases
        j_opt = jopt.adamw(3e-3, weight_decay=0.1,
                           mask=lambda path: path[-1].key != "b")
        t_opt = topt.adamw(3e-3, weight_decay=0.1,
                           mask=lambda path: path[-1] != "b")
    else:
        j_opt, t_opt = make[name](jopt), make[name](topt)
    params = _np_tree(0)
    jp, tp = _jtree(params), _ttree(params)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for step in range(2):
        grads = _np_tree(10 + step)
        ju, js = j_opt.update(_jtree(grads), js, jp,
                              jnp.asarray(step, jnp.int32))
        tu, ts = t_opt.update(_ttree(grads), ts, tp,
                              torch.tensor(step, dtype=torch.int32))
        _close(tu, ju, OPT_TOL, OPT_TOL, f"{name} update {step}")
        jp = jopt.optimizers.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
        _close(tp, jp, OPT_TOL, OPT_TOL, f"{name} params {step}")
    for k in ts:
        if ts[k] is not None:
            _close(ts[k], js[k], OPT_TOL, OPT_TOL, f"{name} state {k}")


@pytest.mark.parametrize("kind", ["warmup_cosine", "cosine", "constant"])
def test_schedules_match_jax(kind):
    make = {
        "warmup_cosine": lambda o: o.linear_warmup_cosine(1.0, 10, 110),
        "cosine": lambda o: o.cosine_schedule(2.0, 100, final_frac=0.2),
        "constant": lambda o: o.constant_schedule(0.3),
    }
    js, ts = make[kind](jopt), make[kind](topt)
    for step in (0, 9, 50, 109):
        want = float(js(jnp.asarray(step, jnp.int32)))
        got = ts(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=OPT_TOL, abs=OPT_TOL)
        assert float(ts(step)) == pytest.approx(float(js(step)), rel=OPT_TOL)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    tree = _np_tree(3)
    jc, jn = jopt.clip_by_global_norm(_jtree(tree), max_norm)
    tc, tn = topt.clip_by_global_norm(_ttree(tree), max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=OPT_TOL)
    _close(tc, jc, OPT_TOL, OPT_TOL, "clipped")


# ---------------------------------------------------------------------------
# the model's training pieces
# ---------------------------------------------------------------------------


def _narrow():
    return (jva.VAConfig(layers=NARROW, spe=jspe.SPEConfig()),
            tva.VAConfig(layers=NARROW, spe=tspe.SPEConfig()))


def _jax_batch(batch: int, step: int = 0, seed: int = 0) -> dict:
    b = jiegm.IEGMStream(batch=batch, seed=seed).batch_at(step)
    return {k: np.asarray(v) for k, v in b.items()}


def _tbatch(b: dict) -> dict:
    return {k: t(v) for k, v in b.items()}


def _t_grad_fn(cfg):
    def gf(params, mb):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = tva.loss_fn(live, mb, cfg)
        grads = torch.autograd.grad(loss, leaves(live))
        it = iter(grads)
        return (tree_map(lambda _: next(it), live),
                tree_map(torch.Tensor.detach, metrics))
    return gf


def _j_grad_fn(cfg):
    def gf(params, mb):
        (_, metrics), g = jax.value_and_grad(
            lambda p, b: jva.loss_fn(p, b, cfg), has_aux=True)(params, mb)
        return g, metrics
    return gf


def test_accumulate_grads_matches_full_batch_and_jax():
    jcfg, tcfg = _narrow()
    params = np_params(NARROW, 1)
    batch = _jax_batch(16)
    tp = convert.params_from_numpy(params, CPU)
    g1, m1 = tacc.accumulate_grads(_t_grad_fn(tcfg), tp, _tbatch(batch), 1)
    g4, m4 = tacc.accumulate_grads(_t_grad_fn(tcfg), tp, _tbatch(batch), 4)
    gj, mj = jacc.accumulate_grads(_j_grad_fn(jcfg), _jtree(params),
                                   _jtree(batch), 4)
    for g in (g1, g4):
        assert _rel(g, gj) <= STEP_RTOL
    assert _rel(g4, tree_map(lambda x: x.numpy(), g1)) <= STEP_RTOL
    for m in (m1, m4):
        assert float(m["loss"]) == pytest.approx(float(mj["loss"]), rel=STEP_RTOL)
    assert float(m4["accuracy"]) == pytest.approx(float(mj["accuracy"]))
    with pytest.raises(ValueError, match="not divisible"):
        tacc.accumulate_grads(_t_grad_fn(tcfg), tp, _tbatch(batch), 3)


CONFIGS = {"CONFIG": (jcfgs.CONFIG, tcfgs.CONFIG),
           "MIXED": (jcfgs.MIXED, tcfgs.MIXED),
           "DENSE": (jcfgs.DENSE, tcfgs.DENSE)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_train_step_match_jax(name):
    """One step of the quickstart's trainer (adam 3e-3, clip 1.0) at full
    width, from the same params and moments on the same batch. The state
    is the reference's after 3 steps, so Adam's moments are warm: from
    cold ones the first update is lr * g / (|g| + eps), and a gradient
    near eps (1.9e-8 in MIXED's conv4 on these inputs) that moves by
    float32 summation order moves its parameter by up to 1e-5 of the
    largest; from warm ones the params agree to about 1e-7."""
    jcfg, tcfg = CONFIGS[name]
    loss_j = lambda p, b: jva.loss_fn(p, b, jcfg)
    opt_j = jopt.adam(3e-3)
    step_j = jax.jit(jtrainer.make_train_step(loss_j, opt_j, clip_norm=1.0))
    state_j = jtrainer.init_state(_jtree(np_params(jcfg.layers, 2)), opt_j)
    for i in range(3):
        state_j, _ = step_j(state_j, _jtree(_jax_batch(8, step=i)))
    batch = _jax_batch(8, step=3)
    opt_t = topt.adam(3e-3)
    state_t = convert.state_from_numpy(jax.tree.map(np.asarray, state_j), CPU)

    loss_t, met_t = tva.loss_fn(state_t["params"], _tbatch(batch), tcfg)
    want_loss, met_j = loss_j(state_j["params"], _jtree(batch))
    assert float(loss_t) == pytest.approx(float(want_loss), rel=STEP_RTOL)
    assert float(met_t["accuracy"]) == float(met_j["accuracy"])

    step_t = ttrainer.make_train_step(
        lambda p, b: tva.loss_fn(p, b, tcfg), opt_t, clip_norm=1.0)
    new_t, m_t = step_t(state_t, _tbatch(batch))
    new_j, m_j = step_j(state_j, _jtree(batch))
    assert float(m_t["loss"]) == pytest.approx(float(m_j["loss"]), rel=STEP_RTOL)
    assert float(m_t["grad_norm"]) == pytest.approx(float(m_j["grad_norm"]),
                                                    rel=STEP_RTOL)
    assert int(new_t["step"]) == int(new_j["step"]) == 4
    assert _rel(new_t["params"], new_j["params"]) <= STEP_RTOL
    for k in ("m", "v"):
        assert _rel(new_t["opt"][k], new_j["opt"][k]) <= STEP_RTOL


def test_twenty_steps_resumed_from_the_reference_state():
    """The reference trains 5 steps; its state goes to the port through
    `state_from_numpy`; both then take 20 steps on the reference's
    batches. Each step's loss agrees within 1e-3."""
    jcfg, tcfg = _narrow()
    opt_j, opt_t = jopt.adam(3e-3), topt.adam(3e-3)
    step_j = jax.jit(jtrainer.make_train_step(
        lambda p, b: jva.loss_fn(p, b, jcfg), opt_j, clip_norm=1.0))
    step_t = ttrainer.make_train_step(
        lambda p, b: tva.loss_fn(p, b, tcfg), opt_t, clip_norm=1.0)
    state_j = jtrainer.init_state(_jtree(np_params(NARROW, 4)), opt_j)
    for i in range(5):
        state_j, _ = step_j(state_j, _jtree(_jax_batch(16, step=i)))
    state_t = convert.state_from_numpy(jax.tree.map(np.asarray, state_j), CPU)
    assert int(state_t["step"]) == 5 and state_t["step"].dtype == torch.int32
    for i in range(5, 25):
        batch = _jax_batch(16, step=i)
        state_j, m_j = step_j(state_j, _jtree(batch))
        state_t, m_t = step_t(state_t, _tbatch(batch))
        assert abs(float(m_t["loss"]) - float(m_j["loss"])) <= 1e-3, i


def test_loss_decreases_over_sixty_steps():
    cfg = tcfgs.CONFIG
    opt = topt.adam(3e-3)
    state = ttrainer.init_state(
        tva.init(torch.Generator().manual_seed(0), cfg, device=CPU), opt,
        device=CPU)
    step = ttrainer.make_train_step(lambda p, b: tva.loss_fn(p, b, cfg), opt)
    stream = tiegm.IEGMStream(batch=16, seed=0, device=CPU)
    losses = []
    for i in range(60):
        state, m = step(state, stream.batch_at(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.3


def test_train_step_with_micro_batches():
    """n_micro = 4 takes the same step as the full batch, up to
    summation order."""
    _, tcfg = _narrow()
    opt = topt.sgd(0.1)
    state = ttrainer.init_state(convert.params_from_numpy(np_params(NARROW, 5),
                                                          CPU), opt, device=CPU)
    batch = _tbatch(_jax_batch(16))
    loss = lambda p, b: tva.loss_fn(p, b, tcfg)
    s1, m1 = ttrainer.make_train_step(loss, opt, clip_norm=0)(state, batch)
    s4, m4 = ttrainer.make_train_step(loss, opt, clip_norm=0, n_micro=4)(state,
                                                                         batch)
    assert float(m4["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=STEP_RTOL)
    assert _rel(s4["params"], tree_map(lambda x: x.numpy(), s1["params"])) \
        <= STEP_RTOL


# ---------------------------------------------------------------------------
# data, schedule, linear layer
# ---------------------------------------------------------------------------


def test_iegm_stream_determinism_sharding_and_balance():
    s0 = tiegm.IEGMStream(batch=8, seed=3, host_id=0, device=CPU)
    s0b = tiegm.IEGMStream(batch=8, seed=3, host_id=0, device=CPU)
    s1 = tiegm.IEGMStream(batch=8, seed=3, host_id=1, device=CPU)
    a, b, c = s0.batch_at(5), s0b.batch_at(5), s1.batch_at(5)
    torch.testing.assert_close(a["signal"], b["signal"], rtol=0, atol=0)
    torch.testing.assert_close(a["label"], b["label"], rtol=0, atol=0)
    assert float((a["signal"] - c["signal"]).abs().max()) > 1e-3
    assert float((a["signal"] - s0.batch_at(6)["signal"]).abs().max()) > 1e-3
    first = next(iter(s0))
    torch.testing.assert_close(first["signal"], s0.batch_at(0)["signal"])
    big = tiegm.IEGMStream(batch=256, seed=0, device=CPU).batch_at(0)
    assert big["signal"].shape == (256, 512)
    assert big["signal"].dtype == torch.float32
    assert big["label"].dtype == torch.int32
    assert 0.35 < float(big["label"].float().mean()) < 0.65
    assert bool(torch.isfinite(big["signal"]).all())


def test_filter_response_db_matches_jax():
    f = np.array([2.0, 5.0, 20.0, 35.0, 50.0, 90.0, 110.0])
    got = tiegm.filter_response_db(f)
    np.testing.assert_allclose(got, jiegm.filter_response_db(f), rtol=1e-6)
    assert got[2] > -3 and got[3] > -3 and got[4] > -6
    assert got[0] < -40 and got[-1] < -40


@pytest.mark.parametrize("step", [0, 5, 10, 37, 63, 100, 200])
def test_sparsity_schedule_matches_jax(step):
    kw = dict(start=10, end=100, final_keep=8, group_size=16)
    want = JS.sparsity_schedule(step, **kw)
    got = TS.sparsity_schedule(step, **kw)
    assert got.dtype == torch.int32
    assert int(got) == int(want)
    got_t = TS.sparsity_schedule(torch.tensor(step, dtype=torch.int32), **kw)
    assert int(got_t) == int(JS.sparsity_schedule(jnp.int32(step), **kw))


@pytest.mark.parametrize("spe", [None, "8bit"])
def test_linear_layer_matches_jax(spe):
    rng = np.random.default_rng(6)
    params = {"w": rng.standard_normal((32, 12)).astype(np.float32),
              "b": rng.standard_normal((12,)).astype(np.float32)}
    x = rng.standard_normal((5, 32)).astype(np.float32)
    jc = jspe.SPEConfig() if spe else None
    tc = tspe.SPEConfig() if spe else None
    want = jspe.linear_apply(_jtree(params), jnp.asarray(x), jc)
    got = tspe.linear_apply(_ttree(params), t(x), tc)
    np.testing.assert_allclose(n(got), n(want), rtol=STEP_RTOL, atol=STEP_RTOL)
    init = tspe.linear_init(torch.Generator().manual_seed(0), 256, 64, CPU)
    assert init["w"].shape == (256, 64) and init["b"].shape == (64,)
    assert float(init["w"].std()) == pytest.approx((2 / 320) ** 0.5, rel=0.05)
    assert not bool(init["b"].any())


def test_quickstart_runs_on_the_cpu(capsys):
    out = quickstart.run(device="cpu", steps=5, batch=8, patients=4)
    assert out["device"] == "cpu"
    assert len(out["losses"]) == 5 and all(np.isfinite(out["losses"]))
    assert 0 <= out["correct"] <= out["patients"] == 4
    assert out["compiled_kib"] > 0 and out["compression"] > 1
    assert out["chip"]["avg_power_uW"] == pytest.approx(10.60, abs=0.01)
    printed = capsys.readouterr().out
    assert "step    0  loss=" in printed
    assert "diagnostic accuracy (synthetic): " in printed

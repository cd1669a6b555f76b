"""PyTorch port vs JAX package: atomic keep-k checkpoints and the
checkpoint-restart training loop with its straggler watchdog
(`repro_torch.train.{checkpoint, fault}` against `repro.train.*`).

The first tests are twins of tests/test_train.py's checkpoint and fault
tests, on a narrow VA trainer state (the LM substrate is not ported).
The rest hold the on-disk format across the packages: states made from
numpy with a seed, the same npz keys and bit-equal arrays, each package
reading the other's checkpoints, a reference run going on in the port
(each step's loss within 1e-3 and the final params within 1e-4 relative,
the tolerances of tests/test_torch_train.py's resumed run: float32
convolutions summed in another order, compounded through Adam), and a
faulted run replaying bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_bridge import CPU, NARROW, n, np_params, t

from repro import optim as jopt
from repro.core import spe as jspe
from repro.core import vadetect as jva
from repro.data import iegm as jiegm
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch import convert, obs, optim as topt
from repro_torch._tree import leaves, tree_map
from repro_torch.core import spe as tspe
from repro_torch.core import vadetect as tva
from repro_torch.data import iegm as tiegm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault, trainer

LOSS_TOL = 1e-3
PARAMS_RTOL = 1e-4


def _setup(opt=None, seed=0):
    """(state, step, stream) of the narrow VA stack on the CPU."""
    cfg = tva.VAConfig(layers=NARROW, spe=tspe.SPEConfig())
    opt = opt or topt.adamw(3e-3)
    state = trainer.init_state(
        convert.params_from_numpy(np_params(NARROW, seed), CPU), opt,
        device=CPU)
    step = trainer.make_train_step(lambda p, b: tva.loss_fn(p, b, cfg), opt,
                                   clip_norm=1.0)
    return state, step, tiegm.IEGMStream(batch=8, seed=seed, device=CPU)


def _assert_trees_equal(got, want):
    """The same structure (None where None) and bit-equal leaves, with
    the same dtypes."""
    pairs = []
    tree_map(lambda g, w: pairs.append((g, w)), got, want)
    for g, w in pairs:
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.device == w.device
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# twins of tests/test_train.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_checkpoint_roundtrip(tmp_path, opt):
    state, step, stream = _setup(topt.adamw(3e-3) if opt == "adamw"
                                 else topt.sgd(0.1))
    state, _ = step(state, stream.batch_at(0))
    path = ckpt.save(state, str(tmp_path), 1)
    assert os.path.isdir(path)
    restored, s = ckpt.restore(str(tmp_path), state)
    assert s == 1
    _assert_trees_equal(restored, state)
    assert restored["step"].dtype == torch.int32 and restored["step"].ndim == 0


def test_checkpoint_keep_k(tmp_path):
    state, _, _ = _setup()
    for s in range(5):
        ckpt.save(state, str(tmp_path), s, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [3, 4]
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_checkpoint_interrupted_save_is_invisible(tmp_path):
    """A crash mid-save (simulated tmp dir) never corrupts LATEST."""
    state, _, _ = _setup()
    ckpt.save(state, str(tmp_path), 1)
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert ckpt.latest_step(str(tmp_path)) == 1
    _, s = ckpt.restore(str(tmp_path), state)
    assert s == 1


def test_gc_out_of_order_save_never_dangles_latest(tmp_path):
    """A rollback re-saves a LOWER step into a dir holding higher ones:
    the saved step is kept, every dead future dir is pruned, and the
    LATEST-lost fallback cannot jump forward."""
    state = {"w": torch.arange(4.0)}
    for s in (10, 20, 30, 40):
        ckpt.save(state, str(tmp_path), s, keep=3)
    rolled = {"w": torch.arange(4.0) * 2}
    ckpt.save(rolled, str(tmp_path), 15, keep=3)
    assert ckpt.latest_step(str(tmp_path)) == 15
    restored, s = ckpt.restore(str(tmp_path), state)
    assert s == 15
    assert torch.equal(restored["w"], rolled["w"])
    assert ckpt.all_steps(str(tmp_path)) == [15]
    os.remove(os.path.join(str(tmp_path), "LATEST"))
    assert ckpt.latest_step(str(tmp_path)) == 15
    ckpt.save(rolled, str(tmp_path), 16, keep=3)
    assert ckpt.latest_step(str(tmp_path)) == 16
    assert ckpt.all_steps(str(tmp_path)) == [15, 16]


def test_gc_interrupted_prune_leaves_no_unloadable_step(tmp_path):
    """A dir whose meta.json is gone (a prune cut mid-rmtree) is invisible,
    so the LATEST-lost fallback picks a complete checkpoint."""
    state = {"w": torch.arange(4.0)}
    for s in (1, 2, 3):
        ckpt.save(state, str(tmp_path), s, keep=10)
    os.remove(os.path.join(str(tmp_path), "step_00000002", "meta.json"))
    assert ckpt.all_steps(str(tmp_path)) == [1, 3]
    os.remove(os.path.join(str(tmp_path), "LATEST"))
    assert ckpt.latest_step(str(tmp_path)) == 3
    _, s = ckpt.restore(str(tmp_path), state)
    assert s == 3


def test_restore_checks_shapes_and_takes_a_device(tmp_path):
    ckpt.save({"w": torch.arange(4.0)}, str(tmp_path), 1)
    with pytest.raises(ValueError, match="w: checkpoint shape"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(5)})
    like = {"w": torch.zeros(4, dtype=torch.float64)}
    restored, _ = ckpt.restore(str(tmp_path), like, device="cpu")
    assert restored["w"].dtype == torch.float64
    assert restored["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), like)


def test_run_training_with_fault_injection(tmp_path):
    """Injected failures trigger checkpoint-restart; the run completes,
    and the telemetry counts every step taken and every retry."""
    state, step, stream = _setup()
    injector = fault.FaultInjector(fail_at={7, 13})
    tel = obs.configure(enabled=True)
    try:
        final, history = fault.run_training(
            step, state, stream.batch_at,
            num_steps=20, ckpt_dir=str(tmp_path), ckpt_every=5,
            fault_hook=injector, log_every=0,
        )
    finally:
        obs.reset()
    assert injector.failures == 2
    assert int(final["step"]) == 20
    assert [h["step"] for h in history][-1] == 19
    # 20 steps, then 7 - 5 and 13 - 10 replayed
    snap = tel.registry.snapshot()
    assert snap["counters"]["train.steps_total"] == len(history) == 25
    assert snap["counters"]["train.retries_total"] == 2
    assert snap["histograms"]["train.step_latency_s"]["count"] == 25
    spans = [e for e in tel.tracer.events() if e["type"] == "span"]
    assert sum(e["name"] == "train/step" for e in spans) == 25


def test_run_training_resumes_from_checkpoint(tmp_path):
    state, step, stream = _setup()
    fault.run_training(step, state, stream.batch_at, num_steps=10,
                       ckpt_dir=str(tmp_path), ckpt_every=5, log_every=0)
    final, history = fault.run_training(
        step, state, stream.batch_at, num_steps=15,
        ckpt_dir=str(tmp_path), ckpt_every=5, log_every=0,
    )
    assert history[0]["step"] == 10
    assert int(final["step"]) == 15


def test_straggler_watchdog_flags():
    w = fault.StragglerWatchdog(threshold=2.0)
    for i in range(10):
        w.record(i, 0.1)
    assert w.record(10, 0.5) is True
    assert len(w.flagged) == 1


def test_faulted_run_replays_bit_for_bit(tmp_path):
    """The faulted run's final state equals a clean run's, bit for bit:
    batches are keyed by step and checkpoints restore exactly."""
    state, step, stream = _setup()
    finals = []
    for name, hook in (("faulted", fault.FaultInjector(fail_at={7, 13})),
                       ("clean", None)):
        final, _ = fault.run_training(
            step, state, stream.batch_at, num_steps=20,
            ckpt_dir=str(tmp_path / name), ckpt_every=5, fault_hook=hook,
            log_every=0)
        finals.append(final)
    _assert_trees_equal(finals[0], finals[1])


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _np_state(opt: str, seed: int, layers=None) -> dict:
    """A trainer state as numpy from a seed: params, the optimizer's state
    (Adam's moments, or SGD's {"mu": None}) and a 0-d int32 step."""
    rng = np.random.default_rng(seed + 100)
    params = np_params(layers or tva.VA_LAYERS, seed)
    moment = lambda: {k: {kk: rng.random(a.shape, np.float32) * 1e-3
                          for kk, a in layer.items()}
                      for k, layer in params.items()}
    return {
        "params": params,
        "opt": {"m": moment(), "v": moment()} if opt == "adamw"
        else {"mu": None},
        "step": np.int32(37),
    }


def _jstate(np_state: dict) -> dict:
    return jax.tree.map(jnp.asarray, np_state)


def _npz(path: str) -> dict:
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("opt,n_keys", [("adamw", 49), ("sgd", 17)])
def test_checkpoint_keys_and_arrays_equal_the_reference(tmp_path, opt, n_keys):
    """At CONFIG width the two packages write the same npz entries in the
    same order (no entry for SGD's empty `mu`), bit-equal arrays of the
    same dtypes, and meta.json with the same keys and leaf count."""
    np_state = _np_state(opt, 1)
    pj = jckpt.save(_jstate(np_state), str(tmp_path / "jax"), 37)
    pt = ckpt.save(convert.state_from_numpy(np_state, CPU),
                   str(tmp_path / "torch"), 37)
    with np.load(os.path.join(pj, "arrays.npz")) as dj, \
            np.load(os.path.join(pt, "arrays.npz")) as dt:
        assert dt.files == dj.files and len(dj.files) == n_keys
    aj, at = _npz(pj), _npz(pt)
    for k in aj:
        assert at[k].dtype == aj[k].dtype and at[k].shape == aj[k].shape, k
        np.testing.assert_array_equal(at[k], aj[k], err_msg=k)
    assert aj["step"].shape == () and aj["step"].dtype == np.int32
    metas = [json.load(open(os.path.join(p, "meta.json"))) for p in (pj, pt)]
    assert metas[0].keys() == metas[1].keys()
    assert metas[0]["n_leaves"] == metas[1]["n_leaves"] == n_keys
    assert metas[0]["step"] == metas[1]["step"] == 37


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_each_package_reads_the_others_checkpoint(tmp_path, opt):
    np_state = _np_state(opt, 2, NARROW)
    tstate = convert.state_from_numpy(np_state, CPU)
    jstate = _jstate(np_state)
    # reference save -> port restore
    jckpt.save(jstate, str(tmp_path / "jax"), 3)
    like = convert.state_from_numpy(_np_state(opt, 9, NARROW), CPU)
    got, s = ckpt.restore(str(tmp_path / "jax"), like)
    assert s == 3
    _assert_trees_equal(got, tstate)
    # port save -> reference restore
    ckpt.save(tstate, str(tmp_path / "torch"), 4)
    got_j, s = jckpt.restore(str(tmp_path / "torch"), jstate)
    assert s == 4
    pairs = []
    tree_map(lambda g, w: pairs.append((g, w)), got_j, tstate)
    for g, w in pairs:
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(np.asarray(g), n(w))
            assert np.asarray(g).dtype == n(w).dtype


def _jax_batch(step: int) -> dict:
    b = jiegm.IEGMStream(batch=16, seed=0).batch_at(step)
    return {k: np.asarray(v) for k, v in b.items()}


def test_training_goes_on_from_a_reference_checkpoint(tmp_path):
    """The reference trains 5 adamw steps and checkpoints; the port
    restores that checkpoint and takes steps 5-9 on the reference's
    batches beside the reference."""
    jcfg = jva.VAConfig(layers=NARROW, spe=jspe.SPEConfig())
    tcfg = tva.VAConfig(layers=NARROW, spe=tspe.SPEConfig())
    opt_j, opt_t = jopt.adamw(3e-3), topt.adamw(3e-3)
    step_j = jax.jit(jtrainer.make_train_step(
        lambda p, b: jva.loss_fn(p, b, jcfg), opt_j, clip_norm=1.0))
    step_t = trainer.make_train_step(
        lambda p, b: tva.loss_fn(p, b, tcfg), opt_t, clip_norm=1.0)
    state_j = jtrainer.init_state(
        jax.tree.map(jnp.asarray, np_params(NARROW, 4)), opt_j)
    for i in range(5):
        state_j, _ = step_j(state_j, jax.tree.map(jnp.asarray, _jax_batch(i)))
    jckpt.save(state_j, str(tmp_path), 5)
    like = trainer.init_state(
        convert.params_from_numpy(np_params(NARROW, 0), CPU), opt_t,
        device=CPU)
    state_t, s = ckpt.restore(str(tmp_path), like)
    assert s == 5 and int(state_t["step"]) == 5
    for i in range(5, 10):
        batch = _jax_batch(i)
        state_j, m_j = step_j(state_j, jax.tree.map(jnp.asarray, batch))
        state_t, m_t = step_t(state_t, {k: t(v) for k, v in batch.items()})
        assert abs(float(m_t["loss"]) - float(m_j["loss"])) <= LOSS_TOL, i
    assert int(state_t["step"]) == int(state_j["step"]) == 10
    pairs = []
    tree_map(lambda g, w: pairs.append((n(g), np.asarray(w))),
             state_t["params"], state_j["params"])
    err = max(float(np.abs(g - w).max()) for g, w in pairs)
    assert err / max(float(np.abs(w).max()) for _, w in pairs) <= PARAMS_RTOL
    assert len(leaves(state_t["params"])) == 2 * len(NARROW)

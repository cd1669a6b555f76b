"""PyTorch port vs JAX package: LM training over `data` and `model` —
`trainer.make_multipod_train_step` with the params placed over `data`
(FSDP) and `model` (TP) and the moments mirroring them (ZeRO-1),
`make_sharded_train_step`, the collectives' adjoints
(`dist.sharding`), the checkpoint of a placed state (kill and resume,
restore on another in-pod layout) and `launch.train --multi-pod PxDxM`.

One module fixture does the multi-rank work: a spawned gloo group of 4
ranks runs the port (`tests/_torch_dist_ranks.py`, `inpod`) while one
subprocess a few cases runs the reference's steps with 4 forced host
devices (`tests/_dist_reference.py inpod`), on the same numpy params
(the port's draws) and `TokenStream(batch=8, seq_len=16, seed=0)`'s
batches, AdamW 3e-3, float32. The cases (`ranks.INPOD_CASES`): the
reduced qwen3-8b on 1x2x2 uncompressed (the FSDP and TP adjoints alone),
2x2x1 `gather`, 2x1x2 `two_stage`, and `make_sharded_train_step` on a
2x2 ("data", "model") mesh; the reduced recurrentgemma on 1x2x2 (its
one KV head split mid-head, RG-LRU on local channels); the reduced
olmoe on 1x4x1 (MoE under FSDP). Each spawn and subprocess has its own
time limit.

recurrentgemma's 3 held steps start from the state 3 steps on one
process leave (`ranks.warm_state`; both sides from it, on the next 3
batches). From the draw, Adam's first update lr·g/(|g| + eps) turns the
float32 noise of its smallest gradients (where |g| is near eps after
clipping) into parameter differences near the bound, and its next
gradients carry them: the reference's own 1x1x1 and 1x2x2 runs then
differ by 4.0e-4 of the params' max, 1.2e-4 of v's
(`tests/_dist_reference.py spread`), past the 1e-4 bound. From a warm
state they agree within 2.5e-6, so the bound below holds the port with
a margin.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from repro_torch import configs as tconfigs
from repro_torch import optim as topt
from repro_torch._tree import leaves, map_with_path, tree_map
from repro_torch.data import lm as tlm
from repro_torch.dist import sharding as tshd
from repro_torch.launch import _spawn
from repro_torch.models import api as tapi
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import trainer as ttrainer

REPO = Path(__file__).resolve().parents[1]
STEPS = 3
LR = 3e-3
ADAM_STEP = LR * (1 - 0.9) / (1 - 0.999) ** 0.5  # largest Adam update
TIMEOUT_S = 80  # each spawn and subprocess
FLIP_SHARE = 0.02  # the share of elements a code flip may move
GRAD_REL = 1e-5
CASES = {c[0]: c for c in ranks.INPOD_CASES}
COMPRESSED = [t for t, c in CASES.items() if c[2] != "f32"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(port record, reference arrays, tmp dir)."""
    tmp = tmp_path_factory.mktemp("inpod")
    stream = tlm.TokenStream(batch=8, seq_len=16, vocab=512, seed=0,
                             device="cpu")
    n_batches = STEPS + max(c[6] for c in ranks.INPOD_CASES)
    batches = [{k: v.numpy() for k, v in stream.batch_at(i).items()}
               for i in range(n_batches)]
    params, warm = {}, {}
    flat = {"cases": np.array(ranks.INPOD_CASES)}
    for i, b in enumerate(batches):
        for k, v in b.items():
            flat[f"batch/{i}/{k}"] = v

    def put(prefix, tree):
        map_with_path(lambda path, p: flat.__setitem__(
            prefix + "/".join(path), p), tree)

    for tag, name, *_, n_warm in ranks.INPOD_CASES:
        if n_warm:
            warm[tag] = ranks.warm_state(name, batches[:n_warm])
            params[tag] = warm[tag]["params"]
            for k in ("m", "v"):
                put(f"{tag}/opt/{k}/", warm[tag]["opt"][k])
            flat[f"{tag}/step"] = warm[tag]["step"]
        else:
            params[tag] = tree_map(lambda p: p.numpy(), tapi.build_model(
                tconfigs.reduced(name), tp=1, max_seq=32).init(
                    0, device="cpu"))
        put(f"{tag}/params/", params[tag])
    np.savez(tmp / "in.npz", **flat)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    procs = {}
    for proc in sorted({c[5] for c in ranks.INPOD_CASES}):
        log = open(tmp / f"ref_{proc}.log", "w")
        procs[proc] = (subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_dist_reference.py"),
             "inpod", proc, str(tmp / "in.npz"), str(tmp / f"ref_{proc}.npz")],
            env=env, stdout=log, stderr=subprocess.STDOUT), log)
    try:
        port = _spawn.run(ranks.inpod, 4, device="cpu",
                          args=({"params": params, "batches": batches,
                                 "warm": warm}, str(tmp)),
                          timeout_s=TIMEOUT_S)
        ref = {}
        for proc, (p, log) in procs.items():
            p.wait(timeout=TIMEOUT_S)
            log.close()
            assert p.returncode == 0, (tmp / f"ref_{proc}.log").read_text()
            ref.update(np.load(tmp / f"ref_{proc}.npz"))
    finally:
        for p, log in procs.values():
            if p.poll() is None:
                p.kill()
            log.close()
    return port, ref, tmp


def _tree(rec: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in rec.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("tag", list(CASES))
def test_losses_and_grad_norms_match_reference(trained, tag):
    port, ref, _ = trained
    for i in range(STEPS):
        for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-4)):
            got = port[f"{tag}/metrics/{k}/{i}"]
            want = float(ref[f"{tag}/metrics/{k}/{i}"])
            assert got == pytest.approx(want, rel=rtol), (k, i)


@pytest.mark.parametrize("tag", list(CASES))
def test_state_after_three_steps_matches_reference(trained, tag):
    """Params, m and v gathered to the global layout (the checkpoint's)
    against the reference's global arrays."""
    port, ref, _ = trained
    for part in ("params", "opt/m", "opt/v"):
        got = _tree(port, f"{tag}/state/{part}/")
        want = _tree(ref, f"{tag}/state/{part}/")
        assert sorted(got) == sorted(want) and got
        for k in got:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, k
        tol = 1e-4 * max(float(np.abs(w).max()) for w in want.values())
        over = sum(int((np.abs(got[k] - want[k]) > tol).sum()) for k in got)
        share = over / sum(w.size for w in want.values())
        worst = max(float(np.abs(got[k] - want[k]).max()) for k in got)
        if CASES[tag][2] == "f32":
            assert share == 0, (part, worst, tol)
        else:
            assert share <= FLIP_SHARE, (part, share)
            if part == "params":
                assert worst <= STEPS * ADAM_STEP, worst


@pytest.mark.parametrize("tag", COMPRESSED)
def test_first_step_error_buffers_match_reference(trained, tag):
    """The whole-leaf residuals in the reference's (n_pod, ...) layout
    after one step: their shapes depend on the pod count alone."""
    port, ref, _ = trained
    n_pod = int(CASES[tag][4].split("x")[0])
    bufs = ("s1", "s2") if CASES[tag][2] == "two_stage" else ("s1",)
    for buf in bufs:
        got = _tree(port, f"{tag}/step0/err/{buf}/")
        want = _tree(ref, f"{tag}/step0/err/{buf}/")
        assert sorted(got) == sorted(want) and got
        for k in got:
            assert got[k].shape == want[k].shape
            assert got[k].shape[0] == n_pod
            m = float(np.abs(want[k]).max())
            diff = np.abs(got[k] - want[k])
            assert (diff > 1e-5 * 254 * m).mean() <= FLIP_SHARE, (buf, k)
            assert diff.max() <= 2 * m * (1 + 1e-3) + 1e-12, (buf, k)
        if buf == "s1":  # whole leaves, whatever the in-pod layout
            assert got["embed/w"].shape == (n_pod, 512, 64)


@pytest.mark.parametrize("name", ["reduce_model", "gather_model",
                                  "model_block", "enter_model",
                                  "gather_block"])
def test_each_collective_has_its_adjoint(trained, name):
    """On a 2x2 mesh in float64: reduce_model's backward is the identity,
    gather_model's a slice, model_block's an all-gather, enter_model's an
    all-reduce, gather_block's a reduce-scatter (sum)."""
    assert trained[0]["adjoint_err"][name] <= 1e-12


@pytest.mark.parametrize("tag", ["qwen3_f32", "rg_f32"])
def test_replicated_leaves_gradients_equal_on_every_rank(trained, tag):
    """Stage A on 1x2x2: every leaf no axis splits (norm scales, RG-LRU's
    conv and gates' biases) has the same gradient on all 4 ranks, bit for
    bit."""
    assert trained[0][f"{tag}/replicated_equal"]


@pytest.mark.parametrize("tag", ["qwen3_f32", "rg_f32", "qwen3_chunked"])
def test_block_gradients_gathered_are_one_process_gradient(trained, tag):
    """Stage A's blocks on 1x2x2, gathered whole, against autograd in one
    process on the whole batch (qwen3 also with its CE chunked over S:
    the head through `_top_params`, the vocab-split logits gathered in
    each checkpointed chunk)."""
    assert trained[0][f"{tag}/whole_vs_one"] <= GRAD_REL


@pytest.mark.parametrize("tag", ["qwen3_f32", "rg_f32"])
def test_backward_collectives_within_the_train_envelope(trained, tag):
    """The collectives of one forward and backward on 1x2x2, by kind,
    within the reference's `_TRAIN_COMM_ENVELOPE` (512 a kind); the
    backward's reduce-scatters are among them."""
    comm = trained[0][f"{tag}/comm"]
    assert comm.get("reduce-scatter", 0) > 0
    assert comm.get("all-reduce", 0) > 0 and comm.get("all-gather", 0) > 0
    assert all(v <= ranks.TRAIN_COMM_ENVELOPE for v in comm.values()), comm


def test_kill_resume_on_1x2x2_bitwise(trained):
    """fault.run_training with restore_shardings: killed after 5 steps
    and resumed, against the uninterrupted 8 (the reference's
    test_multipod_kill_resume_bitwise)."""
    port = trained[0]
    assert port["inpod_kill_resume_bitwise"]
    losses = port["inpod_kill_resume_losses"]
    assert len(losses) == 8 and all(np.isfinite(losses))


def test_checkpoint_restores_on_other_in_pod_layouts(trained):
    """The 1x2x2 checkpoint (params and moments gathered from blocks
    split over data and model, whole error buffers): restored on 1x4x1,
    every rank's block is the saved array's and gathers back to it; and
    unsharded in one process, equal to the saved arrays; bit for bit."""
    port = trained[0]
    saved = np.load(Path(port["inpod_ckpt_dir"]) / "step_00000008"
                    / "arrays.npz")
    assert saved["opt/m/embed/w"].shape == (512, 64)
    assert saved["err/s1/embed/w"].shape == (1, 512, 64)
    assert port["inpod_elastic_1x4x1"]
    assert port["inpod_elastic_unsharded"]


@pytest.mark.parametrize("spec", ["1x2x2", "2x2x1", "2x1x2"])
def test_launch_train_multi_pod_in_pod(trained, spec):
    """`launch.train.main(['--multi-pod', spec, ...])` in the group: the
    params and moments in rank 0's blocks (the 2 groups' wq, (2, 64, 64)
    whole, split over data and model), the error buffers whole, the
    steps finite."""
    rec = trained[0][f"launch_{spec}"]
    _, n_data, n_model = (int(x) for x in spec.split("x"))
    assert rec["step"] == 2 and all(np.isfinite(rec["losses"]))
    assert all(np.isfinite(rec["grad_norms"]))
    assert rec["wq"] == rec["m_wq"] == (2, 64 // n_data, 64 // n_model)
    if spec == "1x2x2":
        assert rec["err_keys"] == [] and rec["err_wq"] is None
    else:
        assert rec["err_wq"] == (1, 2, 64, 64)


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------


def test_elastic_restore_with_shardings(tmp_path):
    """The port's twin of tests/test_train.py's: a checkpoint saved without
    shardings restores under explicitly given ones (here a 1-device
    ("data",) mesh, every leaf replicated), equal to the saved state."""
    cfg = tconfigs.reduced("qwen3_8b")
    model = tapi.build_model(cfg, tp=1, max_seq=32)
    opt = topt.adamw(1e-3)
    state = ttrainer.init_state(model.init(0, device="cpu"), opt,
                                device="cpu")
    tckpt.save(state, str(tmp_path), 3)
    mesh = tshd.MeshShape(("data",), (1,))
    sh = tshd.named(tree_map(lambda _: (), state), mesh)
    like = tree_map(torch.zeros_like, state)
    restored, s = tckpt.restore(str(tmp_path), like, shardings=sh)
    assert s == 3
    assert all(torch.equal(a, b)
               for a, b in zip(leaves(restored), leaves(state)))


def test_sharded_step_without_donation_leaves_its_state():
    """`make_sharded_train_step(donate=False)` on a 1x1 ("data",
    "model") mesh in a world-1 gloo group: the state handed in is left
    as it was, and two steps equal the donated step's bit for bit."""
    from repro_torch.launch.mesh import make_smoke_mesh

    cfg, model = ranks._lm()
    opt = topt.adamw(LR)
    stream = tlm.TokenStream(batch=8, seq_len=16, vocab=cfg.vocab, seed=0,
                             device="cpu")
    fresh = lambda: ttrainer.init_state(  # noqa: E731
        model.init(0, device="cpu"), opt, device="cpu")
    with _spawn.process_group("cpu", timeout_s=TIMEOUT_S):
        mesh = make_smoke_mesh(1, 1, "cpu")
        runs = {}
        for donate in (False, True):
            state = fresh()
            kept = tree_map(torch.clone, state)
            step, _, _ = ttrainer.make_sharded_train_step(
                model.loss, opt, cfg, mesh, state, stream.batch_at(0),
                donate=donate)
            out = state
            for i in range(2):
                out, _ = step(out, stream.batch_at(i))
            runs[donate] = out
            same = all(torch.equal(a, b)
                       for a, b in zip(leaves(state), leaves(kept)))
            assert same is (not donate)
            assert (out is state) is donate
    assert int(runs[False]["step"]) == 2
    assert all(torch.equal(a, b) for a, b in zip(leaves(runs[False]),
                                                 leaves(runs[True])))

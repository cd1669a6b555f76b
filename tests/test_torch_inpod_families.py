"""PyTorch port vs JAX package: the LM families that train over `data`
and `model` beside the dense decoders — MoE with its experts' hidden axis
over `model` (the router replicated, the partial expert outputs summed),
RWKV-6 on its local heads, the paper's co-design QAT (16:8 prune-STE and
8-bit fake-quant) with each row-parallel weight's per-column scales
reduced over `model`, and whisper, whose pure-DP profile (use_tp=False,
fsdp=False) puts rows on every in-pod axis — through
`trainer.make_multipod_train_step` and `launch.train --multi-pod`.

One module fixture does the multi-rank work, as in
`tests/test_torch_inpod_train.py`: a spawned gloo group of 4 ranks runs
the port (`tests/_torch_dist_ranks.py`, `inpod_families`) while one
subprocess a case runs the reference's steps with 4 forced host devices
(`tests/_dist_reference.py inpod`), on the same numpy params (the port's
draws) and each case's own batches (`TokenStream(batch=8, seq_len=16,
seed=0)` at the config's vocabulary; whisper's frames from
`launch.train.lm_batch_at`, the launcher's draw), AdamW 3e-3, float32.
The cases (`ranks.INPOD_FAMILY_CASES`) run 3 steps on 1x2x2 and are held
within the in-pod file's bounds: losses to 1e-5, grad norms to 1e-4,
params and moments to 1e-4 of each tree's max. rwkv6 is held for one
step: the reference does not hold its own 1x1x1 and 1x2x2 layouts to
that bound past it (the note at the cases), and its first Adam update
may flip a param whose clipped gradient sits at Adam's eps, counted and
bounded as the in-pod file bounds its code flips (`FLIP_SHARE`, at most
one Adam step); its m and v, which hold that step's clipped gradient,
are held with no share set aside, and the gradient they hold within
1e-4 of each leaf's own max. No prune or rounding tie flips in the QAT case's 3
steps: its state is held to the bound with no share set aside. Each
spawn and subprocess has its own time limit.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_dist_ranks as ranks
from repro_torch import configs as tconfigs
from repro_torch._tree import map_with_path, tree_map
from repro_torch.data import lm as tlm
from repro_torch.dist import sharding as tshd
from repro_torch.launch import _spawn
from repro_torch.launch import train as tlaunch
from repro_torch.models import api as tapi
from repro_torch.train import trainer as ttrainer

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 80  # each spawn and subprocess
CASES = {c[0]: c for c in ranks.INPOD_FAMILY_CASES}
LR = 3e-3
ADAM_STEP = LR * (1 - 0.9) / (1 - 0.999) ** 0.5  # largest Adam update
FLIP_SHARE = 0.02  # the in-pod file's share of elements a flip may move
# cases whose first Adam update may flip: an element whose clipped
# gradient sits at Adam's eps moves by lr·g/(|g| + eps), ~0 or ~lr, as
# the float32 noise of g falls (rwkv6: 1 of 277 632 params at one step)
ADAM_FLIPS = ("rwkv6_tp",)


def _cfg(case):
    import dataclasses

    return dataclasses.replace(tconfigs.reduced(case[1]), dtype="float32",
                               **case[4])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(port record, reference arrays)."""
    tmp = tmp_path_factory.mktemp("inpod_families")
    flat = {"cases": np.array(ranks.family_rows())}
    params, batches = {}, {}
    for case in ranks.INPOD_FAMILY_CASES:
        tag, cfg = case[0], _cfg(case)
        stream = tlm.TokenStream(batch=8, seq_len=16, vocab=cfg.vocab,
                                 seed=0, device="cpu")
        batch_at = tlaunch.lm_batch_at(stream, cfg, 8)
        batches[tag] = [{k: v.numpy() for k, v in batch_at(i).items()}
                        for i in range(case[5])]
        for i, b in enumerate(batches[tag]):
            for k, v in b.items():
                flat[f"{tag}/batch/{i}/{k}"] = v
        params[tag] = tree_map(lambda p: p.numpy(), tapi.build_model(
            cfg, tp=1, max_seq=32).init(0, device="cpu"))
        map_with_path(lambda path, p, tag=tag: flat.__setitem__(
            f"{tag}/params/" + "/".join(path), p), params[tag])
    np.savez(tmp / "in.npz", **flat)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    procs = {}
    for proc in sorted({c[3] for c in ranks.INPOD_FAMILY_CASES}):
        log = open(tmp / f"ref_{proc}.log", "w")
        procs[proc] = (subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_dist_reference.py"),
             "inpod", proc, str(tmp / "in.npz"), str(tmp / f"ref_{proc}.npz")],
            env=env, stdout=log, stderr=subprocess.STDOUT), log)
    try:
        port = _spawn.run(ranks.inpod_families, 4, device="cpu",
                          args=({"params": params, "batches": batches},
                                str(tmp)),
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
    return port, ref


def _tree(rec: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in rec.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("tag", list(CASES))
def test_losses_and_grad_norms_match_reference(trained, tag):
    port, ref = trained
    for i in range(CASES[tag][5]):
        for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-4)):
            got = port[f"{tag}/metrics/{k}/{i}"]
            want = float(ref[f"{tag}/metrics/{k}/{i}"])
            assert got == pytest.approx(want, rel=rtol), (k, i)


@pytest.mark.parametrize("tag", list(CASES))
def test_state_after_three_steps_matches_reference(trained, tag):
    """Params, m and v gathered to the global layout (the checkpoint's)
    against the reference's global arrays after the case's steps, within
    1e-4 of each tree's max. `ADAM_FLIPS`: the params' flips counted and
    bounded; m and v, which no eps flip moves, held with no share set
    aside, and each leaf's clipped gradient g held within 1e-4 of that
    leaf's own max: after one step m = 0.1·g, and |g| = sqrt(v / 0.001)
    (v itself, a square, doubles g's relative error)."""
    port, ref = trained
    for part in ("params", "opt/m", "opt/v"):
        got = _tree(port, f"{tag}/state/{part}/")
        want = _tree(ref, f"{tag}/state/{part}/")
        assert sorted(got) == sorted(want) and got
        for k in got:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, k
        tol = 1e-4 * max(float(np.abs(w).max()) for w in want.values())
        worst = max(float(np.abs(got[k] - want[k]).max()) for k in got)
        if tag not in ADAM_FLIPS or part != "params":
            assert worst <= tol, (part, worst, tol)
        else:
            over = sum(int((np.abs(got[k] - want[k]) > tol).sum())
                       for k in got)
            share = over / sum(w.size for w in want.values())
            assert share <= FLIP_SHARE, (part, share)
            assert worst <= CASES[tag][5] * ADAM_STEP, (part, worst)
        if tag in ADAM_FLIPS and part != "params":
            grad = np.sqrt if part == "opt/v" else np.abs
            for k in got:
                g_got, g_want = grad(got[k]), grad(want[k])
                leaf_worst = float(np.abs(g_got - g_want).max())
                assert leaf_worst <= 1e-4 * float(g_want.max()), (part, k)


def test_qat_step_at_model_one_is_the_one_process_step(trained):
    """The QAT config's multi-pod step on 1x1x1 equals
    `make_train_step`'s bit for bit over 2 steps: at a model size of 1 no
    scale is reduced and no block is cut."""
    assert trained[0]["qat_1x1x1_bitwise"]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "rwkv6-3b", "qwen3-8b",
                                  "whisper-tiny"])
def test_launch_train_multi_pod_families(trained, arch):
    """`launch.train.main(['--multi-pod', '1x2x2', ...])` for each family
    in the group: 2 finite steps, and in rank 0's state one leaf that the
    model axis splits cut to its block (whisper's embedding whole: every
    in-pod axis carries rows)."""
    rec = trained[0][f"launch_{arch}"]
    assert rec["step"] == 2
    assert all(np.isfinite(rec["losses"]))
    assert all(np.isfinite(rec["grad_norms"]))
    cfg = tconfigs.reduced(arch)
    shapes = tapi.build_model(cfg, tp=1, max_seq=16).init(0, device="cpu")
    path = ranks.FAMILY_LEAVES[arch]
    x = shapes
    for k in path:
        x = x[k]
    spec = tshd.spec_for_path("/".join(path), tuple(x.shape), cfg,
                              tshd.MeshShape(("pod", "data", "model"),
                                             (1, 2, 2)))
    want = list(x.shape)
    for d, entry in enumerate(spec):
        want[d] //= 2 if entry else 1
    assert rec["leaf"] == tuple(want)
    if arch == "whisper-tiny":
        assert rec["leaf"] == tuple(x.shape)
    else:
        assert "model" in tshd._names(spec[-1]) + tshd._names(spec[-2])


def test_qat_row_block_that_cuts_a_group_raises():
    """At model = 8 the reduced qwen3's attention output (64 rows) leaves
    each rank 8 rows, half a 16-row prune group: the state's specs raise,
    naming the leaf."""
    import dataclasses

    cfg = dataclasses.replace(tconfigs.reduced("qwen3_8b"), spe_bits=8,
                              spe_sparse=True)
    params = tapi.build_model(cfg, tp=1, max_seq=16).init(0, device="cpu")
    mesh = tshd.MeshShape(("pod", "data", "model"), (1, 1, 8))
    shapes = {"params": params, "opt": {}, "step": None}
    with pytest.raises(tshd.ShardingGuardError, match="wo/w"):
        ttrainer.state_specs(shapes, cfg, mesh)
    # without the prune the same blocks are exact
    ttrainer.state_specs(shapes, dataclasses.replace(cfg, spe_sparse=False),
                         mesh)

"""PyTorch port vs JAX package: compressed multi-pod training over
`torch.distributed` — `trainer.make_multipod_train_step` at 2 and 4 pods
for each scheme, the error buffers through a checkpoint in the
reference's (n_pod, *leaf) layout, interrupted and killed runs against
the uninterrupted one, `FleetRunner` on a 4-rank data mesh, and
`launch.train --multi-pod` / `launch.stream --devices` through `main`.

Two module fixtures do the multi-rank work. In the first a spawned gloo
group of 4 ranks runs the port's steps (`tests/_torch_dist_ranks.py`),
while six subprocesses (one a scheme and pod count) run the reference
with 4 forced host devices
(`tests/_dist_reference.py`) on the same numpy params and batches (the
port's draws); in the
second another group of 4 holds the port against itself. Each spawn and
subprocess has its own time limit. The reduced qwen3-8b in float32, as
tests/test_torch_lm_train.py holds training (bfloat16 flips compound).

Tolerances, each for its reason:

- a loss: 1e-5 relative (tests/test_torch_lm_train.py), every step;
  grad norms 1e-4 (tests/test_dist.py's rtol);
- the f32 scheme's params, m and v after 3 steps: 1e-4 of each tree's
  max (tests/test_dist.py's 1e-4; from a cold start Adam's first
  updates are near sign(g), so the one-step 1e-5 does not carry over);
- the int8 schemes: the gradients differ in their last bits, so a code
  can fall on the other side of a .5 (ROADMAP.md §3, the int8 KV codes).
  Where it does, the mean moves by one code step (the leaf's scale),
  the residual by the same, and Adam carries it into the params at most
  lr·(1-β1)/sqrt(1-β2) a step. So: the first step's error buffers agree
  within the gradients' 1e-5 of their max (a residual is g + err - q·s:
  its difference is the gradient's, and the gradient's max is 127 code
  steps, 254 times the residual's max) except at the flipped codes (a
  small share), each within one code step (twice the buffer's max, as
  |err| <= scale/2); after 3 steps the params, m and v within 1e-4 of their max
  except at a small share, the params within the Adam bound;
- the port against itself (kill and resume, fault injection, the
  checkpoint round trip, sharded against unsharded predictions): bit for
  bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from repro import configs as jconfigs
from repro.train import trainer as jtrainer
from repro_torch import configs as tconfigs
from repro_torch import optim as topt
from repro_torch._tree import leaves, map_with_path, tree_map
from repro_torch.data import lm as tlm
from repro_torch.models import api as tapi
from repro_torch.dist import compression as TC
from repro_torch.dist import sharding as tshd
from repro_torch.launch import _spawn
from repro_torch.launch import train as tlaunch
from repro_torch.train import trainer as ttrainer

REPO = Path(__file__).resolve().parents[1]
MODES = ("gather", "two_stage", "f32")
PODS = (2, 4)
STEPS = 3
LR = 3e-3
ADAM_STEP = LR * (1 - 0.9) / (1 - 0.999) ** 0.5  # largest Adam update
TIMEOUT_S = 59  # each spawn and subprocess
FLIP_SHARE = 0.02  # the share of elements a code flip may move


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port record, {mode: reference arrays}, tmp dir)."""
    tmp = tmp_path_factory.mktemp("multipod")
    cfg = tconfigs.reduced("qwen3_8b")
    params = tree_map(lambda p: p.numpy(), tapi.build_model(
        cfg, tp=1, max_seq=32).init(0, device="cpu"))
    stream = tlm.TokenStream(batch=8, seq_len=16, vocab=cfg.vocab, seed=0,
                             device="cpu")
    batches = [{k: v.numpy() for k, v in stream.batch_at(i).items()}
               for i in range(STEPS)]
    inputs = {f"batch/{i}/{k}": v for i, b in enumerate(batches)
              for k, v in b.items()}
    map_with_path(lambda path, p: inputs.__setitem__(
        "params/" + "/".join(path), p), params)
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    procs = {}
    for m in MODES:
        for n in PODS:
            tag = f"{m}_{n}"
            log = open(tmp / f"ref_{tag}.log", "w")
            procs[m, n] = (subprocess.Popen(
                [sys.executable, str(REPO / "tests" / "_dist_reference.py"),
                 "multipod", m, str(n), str(tmp / "in.npz"),
                 str(tmp / f"ref_{tag}.npz"), str(tmp / f"ref_ckpt_{tag}")],
                env=env, stdout=log, stderr=subprocess.STDOUT), log)
    try:
        port = _spawn.run(ranks.multipod, 4, device="cpu",
                          args=(params, batches, str(tmp)),
                          timeout_s=TIMEOUT_S)
        ref = {m: {} for m in MODES}
        for (m, n), (p, log) in procs.items():
            p.wait(timeout=TIMEOUT_S)
            log.close()
            assert p.returncode == 0, (tmp / f"ref_{m}_{n}.log").read_text()
            ref[m].update(np.load(tmp / f"ref_{m}_{n}.npz"))
    finally:
        for p, log in procs.values():
            if p.poll() is None:
                p.kill()
            log.close()
    return port, ref, tmp


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The port against itself on a spawned group of 4 gloo ranks."""
    tmp = tmp_path_factory.mktemp("group")
    return _spawn.run(ranks.port_only, 4, device="cpu", args=(str(tmp),),
                      timeout_s=TIMEOUT_S)


def _tree(rec: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in rec.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("n", PODS)
@pytest.mark.parametrize("mode", MODES)
def test_losses_and_grad_norms_match_reference(runs, mode, n):
    port, ref, _ = runs
    for i in range(STEPS):
        for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-4)):
            got = port[f"n{n}/{mode}/metrics/{k}/{i}"]
            want = float(ref[mode][f"n{n}/metrics/{k}/{i}"])
            assert got == pytest.approx(want, rel=rtol), (k, i)


def _parts(port, ref, n, mode, part):
    got = _tree(port, f"n{n}/{mode}/state/{part}/")
    want = _tree(ref[mode], f"n{n}/state/{part}/")
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    return got, want


def _beyond(got, want, tol) -> tuple[float, float]:
    """(share of elements past `tol`, largest difference)."""
    over = sum(int((np.abs(got[k] - want[k]) > tol).sum()) for k in got)
    total = sum(want[k].size for k in want)
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in got)
    return over / total, worst


@pytest.mark.parametrize("n", PODS)
@pytest.mark.parametrize("mode", MODES)
def test_state_after_three_steps_matches_reference(runs, mode, n):
    port, ref, _ = runs
    for part in ("params", "opt/m", "opt/v"):
        got, want = _parts(port, ref, n, mode, part)
        tol = 1e-4 * max(float(np.abs(w).max()) for w in want.values())
        share, worst = _beyond(got, want, tol)
        if mode == "f32":
            assert share == 0, (part, worst, tol)
        else:
            assert share <= FLIP_SHARE, (part, share)
            if part == "params":
                assert worst <= STEPS * ADAM_STEP, worst


@pytest.mark.parametrize("n", PODS)
@pytest.mark.parametrize("mode", ["gather", "two_stage"])
def test_first_step_error_buffers_match_reference(runs, mode, n):
    """Per-pod residuals in the reference's (n_pod, ...) layout after one
    step from the same state: equal but where a code flipped."""
    port, ref, _ = runs
    for buf in ("s1", "s2") if mode == "two_stage" else ("s1",):
        got = _tree(port, f"n{n}/{mode}/step0/err/{buf}/")
        want = _tree(ref[mode], f"n{n}/step0/err/{buf}/")
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].shape == want[k].shape
            assert got[k].shape[0] == n
            m = float(np.abs(want[k]).max())
            diff = np.abs(got[k] - want[k])
            # |err| <= scale/2 and amax = 127 scales: the gradient's
            # agreement, 1e-5 of its max (one step), is 1e-5·254·m here
            assert (diff > 1e-5 * 254 * m).mean() <= FLIP_SHARE, (buf, k)
            assert diff.max() <= 2 * m * (1 + 1e-3) + 1e-12, (buf, k)


def test_error_buffers_checkpoint_in_the_reference_layout(runs):
    """The 4-pod two_stage checkpoint: the reference's npz keys, shapes
    and dtypes (err leaves (n_pod, ...)), the gathered buffers bit for
    bit, restored bit for bit on every rank; a 2-pod state refuses it."""
    port, ref, tmp = runs
    ours = np.load(Path(port["ckpt_path"]) / "arrays.npz")
    theirs = np.load(tmp / "ref_ckpt_two_stage_4" / "step_00000003"
                     / "arrays.npz")
    assert list(ours.keys()) == list(theirs.keys())
    for k in theirs.keys():
        assert ours[k].shape == theirs[k].shape, k
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k],
                                      port[f"n4/two_stage/state/{k}"])
    assert ours["err/s1/embed/w"].shape[0] == 4
    assert port["ckpt_restored_bitwise"]
    assert port["ckpt_other_pod_count_refused"]


def test_kill_resume_and_fault_injection_bitwise(group):
    port = group
    assert port["kill_resume_bitwise"]
    losses = port["kill_resume_losses"]
    assert len(losses) == 8 and all(np.isfinite(losses))


def test_fleet_runner_on_a_data_mesh(group):
    port = group
    assert port["fleet_same_predictions"]
    assert port["fleet_sharding_verified"]
    assert port["fleet_indivisible_refused"]
    assert port["fleet_twin_n_devices"] == port["fleet_kernel_n_devices"] == 4


def test_stream_throughput_device_sweep(group):
    port = group
    cells, scaling = port["sweep_cells"], port["sweep_scaling"]
    assert sorted({c["devices"] for c in cells}) == [1, 2, 4]
    assert all(c["batch_sharded_over_devices"] for c in cells)
    assert all(c["dropped_total"] == 0 for c in cells)
    assert scaling["devices_lo"] == 1 and scaling["devices_hi"] == 4
    assert scaling["modeled_speedup"] == pytest.approx(4.0)


def test_entry_points_over_the_group(group):
    """launch.train --multi-pod 4x1 / 2x1 and launch.stream --devices 4
    through `main` inside the 4-rank group."""
    port = group
    for spec, keys in (("4x1", ["s1", "s2"]), ("2x1", [])):
        losses = port[f"train_{spec}_losses"]
        assert len(losses) == 3 and all(np.isfinite(losses))
        assert port[f"train_{spec}_err_keys"] == keys
    assert port["stream_devices"] == 4
    assert port["stream_metrics"]["dropped_total"] == 0
    assert port["stream_metrics"]["segments_total"] == 16 * 4


def test_launch_train_multi_pod_spawns_its_ranks(monkeypatch):
    """`launch.train.main(['--multi-pod', '2x1', ...], device='cpu')`
    with no group: two gloo ranks spawned, rank 0's record back."""
    monkeypatch.setattr(_spawn, "TIMEOUT_S", TIMEOUT_S)
    out = tlaunch.main(["--arch", "qwen3-8b", "--reduced", "--multi-pod",
                        "2x1", "--scheme", "gather", "--steps", "2",
                        "--batch", "4", "--seq", "8", "--log-every", "0"],
                       device="cpu")
    assert [h["step"] for h in out["history"]] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    s1 = out["state"]["err"]["s1"]["embed"]["w"]
    assert s1.shape[0] == 1 and bool(s1.abs().sum() > 0)
    assert int(out["state"]["step"]) == 2


# ---------------------------------------------------------------------------
# in-process: refusals and the error buffers' shapes
# ---------------------------------------------------------------------------


def test_multi_pod_refuses_va_cnn_and_in_pod_axes(capsys):
    with pytest.raises(SystemExit, match="va-cnn"):
        tlaunch.main(["--arch", "va-cnn", "--multi-pod", "2x1"],
                     device="cpu")
    for spec in ("2x2", "1x1x2"):
        with pytest.raises(SystemExit):
            tlaunch.main(["--arch", "qwen3-8b", "--reduced", "--multi-pod",
                          spec], device="cpu")
        assert "ROADMAP.md queue 1 item 8b" in capsys.readouterr().err


def test_multipod_step_requires_a_pod_axis_and_one_rank_a_pod():
    cfg = jconfigs.reduced("qwen3_8b")
    opt = topt.adamw(1e-3)
    with pytest.raises(ValueError, match="pod"):
        ttrainer.make_multipod_train_step(
            lambda p, b: (0.0, {}), opt, cfg,
            tshd.MeshShape(("data", "model"), (1, 1)), {})
    with pytest.raises(ValueError, match="item 8b"):
        ttrainer.make_multipod_train_step(
            lambda p, b: (0.0, {}), opt, cfg,
            tshd.MeshShape(("pod", "data", "model"), (2, 2, 1)), {})


@pytest.mark.parametrize("n", [1, 4])
def test_init_dp_err_shapes_and_validation(n):
    """Each rank's block: the reference's (n_pod, ...) buffers' row."""
    params = {"w": torch.zeros((5, 3)), "b": torch.zeros((7,))}
    mesh = tshd.MeshShape(("pod",), (n,))
    with pytest.raises(ValueError, match="scheme"):
        ttrainer.init_dp_err(params, mesh, scheme="bogus")
    assert ttrainer.init_dp_err(params, mesh, compress=False) == {}
    err = ttrainer.init_dp_err(params, mesh, scheme="two_stage")
    assert tuple(err["s1"]["w"].shape) == (1, 5, 3)
    assert tuple(err["s2"]["w"].shape) == (1, TC.two_stage_shard_len(15, n))
    assert tuple(err["s2"]["b"].shape) == (1, TC.two_stage_shard_len(7, n))
    if n == 1:  # the reference's, on this process's one device
        jmesh = jax.make_mesh((1,), ("pod",),
                              axis_types=(jax.sharding.AxisType.Auto,))
        jerr = jtrainer.init_dp_err(
            {"w": np.zeros((5, 3), np.float32),
             "b": np.zeros((7,), np.float32)}, jmesh, scheme="two_stage")
        for buf in ("s1", "s2"):
            for k in ("w", "b"):
                assert tuple(jerr[buf][k].shape) == tuple(err[buf][k].shape)


def test_the_card_needs_nccl_and_a_card(monkeypatch):
    """No gloo on the card and no CPU fallback: without a card or without
    NCCL the backend choice raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _spawn.backend("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "qwen3-8b", "--reduced", "--multi-pod",
                      "1x1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_nccl_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        _spawn.backend("cuda")
    assert _spawn.backend("cpu") == "gloo"


@pytest.mark.parametrize("scheme", ["gather", "two_stage"])
def test_launch_train_one_pod_in_process(scheme):
    """`--multi-pod 1x1` runs in this process (a world-1 gloo group,
    destroyed after). Uncompressed, one pod's mean is its own gradient:
    the run equals `launch.train` without `--multi-pod` bit for bit; the
    int8 schemes train from the same first loss."""
    base = ["--arch", "qwen3-8b", "--reduced", "--steps", "3", "--batch",
            "4", "--seq", "8", "--log-every", "0"]
    plain = tlaunch.main(base, device="cpu")
    f32 = tlaunch.main([*base, "--multi-pod", "1x1", "--no-compress"],
                       device="cpu")
    assert not torch.distributed.is_initialized()
    keys = ("loss", "grad_norm")
    assert [[h[k] for k in keys] for h in f32["history"]] == \
        [[h[k] for k in keys] for h in plain["history"]]
    assert all(torch.equal(a, b) for a, b in zip(
        leaves(f32["state"]["params"]), leaves(plain["state"]["params"])))
    out = tlaunch.main([*base, "--multi-pod", "1x1", "--scheme", scheme],
                       device="cpu")
    assert out["history"][0]["loss"] == plain["history"][0]["loss"]
    assert sorted(out["state"]["err"]) == (
        ["s1", "s2"] if scheme == "two_stage" else ["s1"])

"""The load lab's serve sweeps over a mesh on the CPU: `launch.serve
--load-sweep --mesh` and `--frontend-sweep --mesh` over 2 spawned gloo
ranks, at `--mesh 2` (data) and `--mesh 1x2` (model).

Rank 0 runs the sweep and sends each tick's submits and tick, and each
frontend it builds, to the other rank before acting on them
(`serve.frontend.RecordedEngine`); the other replays them
(`serve.frontend.follow_sweep`). The reference is one process over its
devices and has no such layer, so these hold the port against itself:
every request's tokens equal the unsharded sweep's at the same seed (the
reduced qwen3 keeps its greedy tokens over both meshes,
tests/test_torch_sharded.py), every request is accounted for (the serve
sweep's latencies, the frontend's submitted == completed + rejected), and
the spawned run returns, so the follower's replay ended at rank 0's stop.
The sweeps are wall-clock: their knees and verdicts are not compared.
"""

import pytest
from _torch_dist_ranks import (
    SWEEP_FLAGS,
    capture_requests,
    request_tokens,
    serve_sweeps,
)

from repro_torch.launch import _spawn
from repro_torch.launch import serve as tlaunch

ARGV = ("--arch", "qwen3-8b", "--reduced", "--batch", "2", "--prompt-len",
        "6", "--max-new", "3", "--load-requests", "6", "--load-fractions",
        "0.5,4")
MESHES = ("2", "1x2")
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def sweeps():
    """(the mesh runs, rank 0's, and the unsharded runs, this process's)."""
    meshed = _spawn.run(serve_sweeps, 2, device="cpu",
                        args=(list(ARGV), list(MESHES)), timeout_s=TIMEOUT_S)
    single = {}
    for flags in SWEEP_FLAGS:
        wrapped, seen = capture_requests(tlaunch._build_lm_engine)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tlaunch, "_build_lm_engine", wrapped)
            rec = tlaunch.main(list(ARGV) + list(flags), device="cpu")
        single[flags[0]] = {"record": rec, "tokens": request_tokens(seen)}
    return meshed, single


@pytest.mark.parametrize("spec", MESHES)
@pytest.mark.parametrize("sweep", [f[0] for f in SWEEP_FLAGS])
def test_sweep_over_a_mesh_gives_the_unsharded_tokens(sweeps, spec, sweep):
    meshed, single = sweeps
    got = meshed[(spec, sweep)]["tokens"]
    want = single[sweep]["tokens"]
    # the warm-up's requests and every point's: the same (uid, prompt)s
    assert set(got) == set(want) and len(got) >= 6
    assert got == want


@pytest.mark.parametrize("spec", MESHES)
def test_load_sweep_over_a_mesh_accounts_every_request(sweeps, spec):
    rec = sweeps[0][(spec, "--load-sweep")]["record"]
    assert len(rec["points"]) == 2
    for p in rec["points"]:
        assert p["n_requests"] == p["latency"]["count"] == 6
        assert None not in (p["p50_s"], p["p99_s"], p["p999_s"])
    assert rec["coordinated_omission_guard"]["intended_ge_dequeue"]
    assert set(rec) == set(sweeps[1]["--load-sweep"]["record"])


@pytest.mark.parametrize("spec", MESHES)
def test_frontend_sweep_over_a_mesh_accounts_every_request(sweeps, spec):
    rec = sweeps[0][(spec, "--frontend-sweep")]["record"]
    assert len(rec["points"]) == 2
    for p in rec["points"]:
        assert p["submitted"] == p["completed"] + p["rejected"] == 6
        assert sum(p["rejected_by_reason"].values()) == p["rejected"]
        assert p["segments"]["urgent_not_enqueued"] == 0
        assert p["segments"]["dropped"] == 0
    assert rec["overload"]["accounting_exact"]
    assert rec["overload"]["urgent_survived"]
    assert set(rec["transport_overhead"]["p99_s"]) == {"socket", "inproc"}
    assert set(rec) == set(sweeps[1]["--frontend-sweep"]["record"])

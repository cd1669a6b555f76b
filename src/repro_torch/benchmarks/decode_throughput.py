"""Sharded LM decode throughput: tokens/s vs device count, with
per-device decode-cache memory accounted from the placement plan.

Port of `benchmarks/decode_throughput.py`. Two throughput views per
(arch, mesh) cell:

  * wall — what this host sustains through the sharded decode loop
    (`serve.sharded.compile_decode` on each rank's blocks). Gloo ranks on
    the CPU share the container's few cores, so wall numbers need not
    scale with the rank count;
  * modeled device fleet — decode is memory-bound: each batched step
    streams every placed parameter byte plus the pool's decode cache
    through one device's memory system. Per-device step time is (param +
    cache bytes per device) / HBM bandwidth, both from the plan
    (`serve.sharded.DecodePlan`), at the reference's nominal bandwidth
    (`HBM_BW_BYTES_PER_S`, a TPU-class twin's, not the card's), so
    tokens/s scales with devices as the placement shrinks the per-device
    byte footprint. A roofline, not a measurement.

A third section measures admission: the engine seats requests by batched
prefill + per-slot cache scatter (`serve.seating`), so the work per
admitted request is O(prompt), independent of the pool size.
`admission_work` counts the (row x token) units the engine's prefill
cells processed (`Engine.admission_rowsteps`) at two pool sizes and
checks they are identical; the replay counterfactual (prompt x pool per
request) is recorded beside it. A fourth, `paged`, holds the paged pool
against the dense one at the same cache byte budget: >= 2x the
concurrent tenants, every page returned after a drain, no new cell
signature after the warm-up wave.

The meshes are the reference's: "1", "8" and "4x2" with `--smoke` ("2"
and "4" too without), one process a device (`launch._spawn`): gloo ranks
on the CPU (8 spawned, as the reference forces 8 host devices), and on
the card the meshes its ranks hold — "1" on one card over NCCL. Each cell
records the device it ran on. The reference's admission section adds its
"8"-mesh sharded engine where 8 devices exist; so does this one.

The record carries the shared `telemetry` section and a `cell_audit`
section (`repro_torch.analysis.audit_section`) over every serve cell the
run registered — the engines' decode steps, admission prefills, seats and
chunk cells, the sharded engine's per-width cells with their budgets —
gated at zero violations. `check` holds every assertion of the
reference's `main`; the ones about the 8-device mesh's cells apply where
those cells ran (a single card runs none of them, as the reference on
one device would not).

The record is printed in summary and written only where `--out` says:
never to the repository's BENCH_decode.json, which holds the JAX
package's runs.

    python -m repro_torch.benchmarks.decode_throughput [--smoke] \\
        [--out PATH]

`main(argv, device="cpu")` and `run(smoke, device="cpu")` run it over
spawned gloo ranks on the CPU; `device=None` means the CUDA card (one
rank a card) and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from repro_torch import _device, configs, obs
from repro_torch._tree import leaves
from repro_torch.analysis import audit_section
from repro_torch.launch import _spawn
from repro_torch.launch.mesh import make_serving_mesh, parse_mesh_spec
from repro_torch.models import api
from repro_torch.serve import engine as E
from repro_torch.serve import sharded as SH

# Nominal HBM bandwidth of one modeled serving device (the reference's
# TPU-class twin). Only ratios across meshes matter for the scaling
# claim; the absolute tokens/s is a roofline, not a measurement.
HBM_BW_BYTES_PER_S = 819e9

ARCHS = ("qwen3_8b", "recurrentgemma_2b")  # attention KV + recurrent cache
CPU_RANKS = 8  # the reference's forced host devices


def modeled_tokens_per_s(plan: SH.DecodePlan) -> float:
    """Memory-bound decode roofline: one pool step streams the placed
    params + cache once per device; the whole pool advances one token."""
    step_bytes = plan.param_bytes_per_device + plan.cache_bytes_per_device
    return plan.batch / (step_bytes / HBM_BW_BYTES_PER_S)


def _where(dev: torch.device) -> str:
    return (f"{torch.cuda.get_device_name(dev)} (nccl)"
            if dev.type == "cuda" else "cpu (gloo)")


def run_cell(model, params, mesh_spec: str, *, batch: int, prompt_len: int,
             max_new: int, seed: int = 0,
             device: _device.DeviceLike = None) -> Optional[dict]:
    """One (arch, mesh) cell on every rank of the mesh (None on a rank
    outside it): the plan, this rank's blocks, a warm-up prefill and
    decode step, then one timed prefill + `max_new` greedy decode steps
    on this rank's rows of the pool."""
    dev = _device.resolve(device)
    cfg = model.cfg
    mesh = make_serving_mesh(mesh_spec, dev)
    if mesh.get_coordinate() is None:
        return None
    plan = SH.plan_decode(model, params, mesh, batch_size=batch)
    prefill, decode = SH.compile_decode(model, plan)
    placed = SH.place_params(params, plan)
    gen = torch.Generator().manual_seed(seed)
    lo, hi = plan.rows
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=gen)[lo:hi].to(dev)

    def pos_at(t: int) -> torch.Tensor:
        return torch.full((hi - lo,), prompt_len + t, dtype=torch.long,
                          device=dev)

    # warm-up: every first use outside the timed region
    logits, cache = prefill(placed, prompts)
    tok = torch.argmax(logits, dim=-1)
    logits, cache = decode(placed, cache, tok, pos_at(0))
    obs.synchronize(logits)

    t0 = time.monotonic()
    logits, cache = prefill(placed, prompts)
    tok = torch.argmax(logits, dim=-1)
    for t in range(max_new):
        logits, cache = decode(placed, cache, tok, pos_at(t))
        tok = torch.argmax(logits, dim=-1)
    obs.synchronize(tok)
    dt = time.monotonic() - t0
    return {
        "arch": cfg.name,
        "mesh": mesh_spec,
        "devices": plan.n_devices,
        "n_data": plan.n_data,
        "batch": batch,
        "prompt_len": prompt_len,
        "max_new": max_new,
        "wall_s": dt,
        "wall_tokens_per_s": batch * max_new / dt,
        "modeled_tokens_per_s": modeled_tokens_per_s(plan),
        "param_bytes_per_device": plan.param_bytes_per_device,
        "cache_bytes_per_device": plan.cache_bytes_per_device,
        "cache_bytes_replicated_baseline": plan.cache_bytes_total,
        "cache_replication_factor": plan.cache_replication_factor,
        "device": _where(dev),
    }


def _prompt(seed: int, n: int, vocab: int) -> torch.Tensor:
    return torch.randint(0, vocab, (n,),
                         generator=torch.Generator().manual_seed(seed))


def _admission_cell(model, *, pool: int, n_requests: int, prompt_len: int,
                    mesh_spec=None, params=None,
                    device: _device.DeviceLike = None) -> dict:
    """Admit `n_requests` into a `pool`-slot engine and report the
    measured admission work (row x token units through prefill cells)."""
    dev = _device.resolve(device)
    cfg = model.cfg
    if mesh_spec is None:
        eng = E.Engine(model, params, batch_size=pool, device=dev)
    else:
        eng = SH.ShardedEngine(model, params, batch_size=pool,
                               mesh=make_serving_mesh(mesh_spec, dev),
                               device=dev)
    reqs = [E.Request(uid=i, prompt=_prompt(10 + i, prompt_len, cfg.vocab),
                      max_new=3)
            for i in range(n_requests)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=50)
    assert all(r.done for r in reqs)
    return {
        "arch": cfg.name,
        "mesh": mesh_spec or "1",
        "pool": pool,
        "n_requests": n_requests,
        "prompt_len": prompt_len,
        "admission_rowsteps": eng.admission_rowsteps,
        "admission_prefills": eng.admission_prefills,
        "admission_work_per_request": eng.admission_rowsteps / n_requests,
        # what replay admission would have spent: every prompt token
        # stepped through the whole pool, per request
        "replay_rowsteps_counterfactual": n_requests * prompt_len * pool,
    }


def measure_admission(arch: str, *, prompt_len: int,
                      device: _device.DeviceLike = None) -> list:
    """Admission-work cells at two pool sizes on rank 0 (plus the
    8-device data mesh's on every rank, where the group has 8):
    `admission_rowsteps` must not change with the pool."""
    dev = _device.resolve(device)
    cfg = configs.reduced(arch)
    model = api.build_model(cfg, tp=1, max_seq=prompt_len + 6)
    params = model.init(0, device=dev)
    cells = []
    if _spawn.rank() == 0:
        cells += [_admission_cell(model, pool=pool, n_requests=4,
                                  prompt_len=prompt_len, params=params,
                                  device=dev)
                  for pool in (4, 8)]
    if _spawn.world_size() >= 8:
        cells += [_admission_cell(model, pool=pool, n_requests=4,
                                  prompt_len=prompt_len, mesh_spec="8",
                                  params=params, device=dev)
                  for pool in (8, 16)]
    return cells


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def _drive_paged(eng, reqs, *, max_ticks: int = 600) -> tuple:
    """Submit `reqs`, drain, and report (peak concurrent tenants, peak
    resident cache bytes) observed across the ticks."""
    for r in reqs:
        eng.submit(r)
    peak = 0
    peak_bytes = 0
    for _ in range(max_ticks):
        n = eng.tick()
        peak = max(peak, sum(s is not None for s in eng._slots))
        peak_bytes = max(peak_bytes, eng.cache_bytes_in_use())
        if n == 0 and not eng._queue:
            break
    assert all(r.done for r in reqs), "paged workload did not drain"
    return peak, peak_bytes


def measure_paged(arch: str, device: _device.DeviceLike = None) -> dict:
    """The paged-cache tenancy cell: dense vs paged pool at (at most) the
    same cache byte budget, mixed-length workload, two identical waves
    (the first warms every cell, the second must bring no new cell
    signature); resident cache bytes back to the initial value after each
    drain."""
    from repro_torch.serve.paging import PagingConfig, pages_for_position

    dev = _device.resolve(device)
    meta = torch.device("meta")
    cfg = configs.reduced(arch)
    max_seq, page = 128, 4
    model = api.build_model(cfg, tp=1, max_seq=max_seq)
    params = model.init(0, device=dev)
    dense_slots, paged_slots = 4, 16
    span = max((c // page for c in model.attn_capacities()), default=0)
    dense_total = _tree_bytes(model.init_cache(dense_slots, device=meta))
    # paged bytes are affine in n_pages: fit the byte budget exactly
    b2 = _tree_bytes(model.init_cache_paged(paged_slots, 2, page,
                                            device=meta))
    b3 = _tree_bytes(model.init_cache_paged(paged_slots, 3, page,
                                            device=meta))
    slope = b3 - b2
    n_pages = int((dense_total - (b2 - 2 * slope)) // slope)
    paged_total = b2 + (n_pages - 2) * slope
    assert paged_total <= dense_total, (paged_total, dense_total)

    short_len, long_len, max_new = 4, 40, 8

    def mkreqs(uid0):
        reqs = [E.Request(uid=uid0 + i,
                          prompt=_prompt(uid0 + i, short_len, cfg.vocab),
                          max_new=max_new)
                for i in range(paged_slots - 2)]
        reqs += [E.Request(uid=uid0 + 100 + i,
                           prompt=_prompt(uid0 + 100 + i, long_len,
                                          cfg.vocab),
                           max_new=max_new)
                 for i in range(2)]
        return reqs

    # the workload's worst-case page demand must fit, or admission
    # deferral would cap the concurrency this cell is measuring
    worst = (paged_slots - 2) * pages_for_position(
        short_len + max_new - 2, page, span
    ) + 2 * pages_for_position(long_len + max_new - 2, page, span)
    assert worst <= n_pages - 1, (worst, n_pages)

    dense = E.Engine(model, params, batch_size=dense_slots, device=dev)
    paged = E.Engine(
        model, params, batch_size=paged_slots,
        paging=PagingConfig(page_size=page, n_pages=n_pages),
        chunk_tokens=2 * page, device=dev,
    )
    initial_bytes = paged.cache_bytes_in_use()

    probe = obs.get().probe
    dense_peak, _ = _drive_paged(dense, mkreqs(0))
    paged_peak, peak_bytes = _drive_paged(paged, mkreqs(200))
    drain1_bytes = paged.cache_bytes_in_use()
    snap = probe.snapshot()
    dense_peak2, _ = _drive_paged(dense, mkreqs(400))
    paged_peak2, peak_bytes2 = _drive_paged(paged, mkreqs(600))
    misses = probe.new_misses(snap)
    paged._pg.check_invariants()

    return {
        "arch": cfg.name,
        "page_size": page,
        "n_pages": n_pages,
        "span": span,
        "max_seq": max_seq,
        "chunk_tokens": 2 * page,
        "dense_pool_slots": dense_slots,
        "paged_pool_slots": paged_slots,
        "dense_cache_bytes_total": dense_total,
        "paged_cache_bytes_total": paged_total,
        "dense_peak_concurrent": max(dense_peak, dense_peak2),
        "paged_peak_concurrent": max(paged_peak, paged_peak2),
        "concurrency_gain": max(paged_peak, paged_peak2)
        / max(dense_peak, dense_peak2),
        "bytes_in_use": {
            "initial": initial_bytes,
            "peak": max(peak_bytes, peak_bytes2),
            "post_drain": drain1_bytes,
            "post_drain_final": paged.cache_bytes_in_use(),
        },
        "recompiles_after_warmup": sum(misses.values()),
        "recompiles_after_warmup_by_cell": misses,
        # so check() can reconcile the registry's global admission
        # counters, which these two engines also feed
        "admission_rowsteps": dense.admission_rowsteps
        + paged.admission_rowsteps,
        "admission_prefills": dense.admission_prefills
        + paged.admission_prefills,
    }


def mesh_specs(smoke: bool, world: int) -> list:
    """The reference's meshes that `world` ranks hold."""
    specs = ["1", "8", "4x2"] if smoke else ["1", "2", "4", "8", "4x2"]
    return [s for s in specs
            if (lambda dm: dm[0] * dm[1])(parse_mesh_spec(s)) <= world]


def scaling_rows(cells: list) -> list:
    """Device-count scaling per arch (the modeled fleet's: the deployment
    quantity; the wall numbers are reported beside it)."""
    out = []
    for arch in ARCHS:
        ac = [c for c in cells if c["arch"] == configs.reduced(arch).name]
        lo = min(ac, key=lambda c: c["devices"])
        hi = max(ac, key=lambda c: c["devices"])
        out.append({
            "arch": lo["arch"],
            "devices_lo": lo["devices"],
            "devices_hi": hi["devices"],
            "modeled_tokens_per_s_lo": lo["modeled_tokens_per_s"],
            "modeled_tokens_per_s_hi": hi["modeled_tokens_per_s"],
            "modeled_speedup": hi["modeled_tokens_per_s"]
            / lo["modeled_tokens_per_s"],
            "cache_bytes_per_device_lo": lo["cache_bytes_per_device"],
            "cache_bytes_per_device_hi": hi["cache_bytes_per_device"],
            "wall_tokens_per_s_lo": lo["wall_tokens_per_s"],
            "wall_tokens_per_s_hi": hi["wall_tokens_per_s"],
        })
    return out


def run_rank(smoke: bool, *, batch: int = 32, prompt_len: int = 8,
             max_new: int = 24, trace_out: Optional[str] = None,
             device: _device.DeviceLike = None) -> Optional[dict]:
    """The benchmark on this rank of the process group (every rank calls
    it): rank 0 returns the record, the others None; with `trace_out`
    rank 0 writes its telemetry trace to `trace_out.jsonl` +
    `trace_out.json`."""
    dev = _device.resolve(device)
    # before any engine is built, so its cells register with the probe
    obs.configure(enabled=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    world = _spawn.world_size()
    cells = []
    for arch in ARCHS:
        # model and params are mesh-independent: built once an arch
        cfg = configs.reduced(arch)
        model = api.build_model(cfg, tp=1,
                                max_seq=prompt_len + max_new + 2)
        params = model.init(0, device=dev)
        for spec in mesh_specs(smoke, world):
            cell = run_cell(model, params, spec, batch=batch,
                            prompt_len=prompt_len, max_new=max_new,
                            device=dev)
            if cell is None or _spawn.rank() != 0:
                continue
            cells.append(cell)
            print(
                f"[decode_throughput] {cell['arch']:24s} mesh={spec:4s} "
                f"wall={cell['wall_tokens_per_s']:8.0f} tok/s "
                f"modeled={cell['modeled_tokens_per_s'] / 1e6:8.2f} "
                f"Mtok/s cache/dev={cell['cache_bytes_per_device']:8d} B "
                f"(repl {cell['cache_bytes_replicated_baseline']:8d} B)",
                flush=True,
            )
    admission = measure_admission(ARCHS[0], prompt_len=prompt_len,
                                  device=dev)
    if _spawn.rank() != 0:
        return None
    paged = measure_paged(ARCHS[0], device=dev)
    # the cell audit over everything the run registered: the engines'
    # serve.decode_step / prefill / seat / chunk cells and the sharded
    # engine's per-width ones, from their recorded first calls
    cell_audit = audit_section()
    if trace_out:
        jsonl, chrome = obs.get().finish(trace_out)
        print(f"[obs] trace written: {jsonl} + {chrome}")
    return {
        "benchmark": "decode_throughput",
        "n_host_devices": world,
        "hbm_bw_bytes_per_s": HBM_BW_BYTES_PER_S,
        "reduced_configs": True,
        "cells": cells,
        "scaling": scaling_rows(cells),
        "admission": admission,
        "paged": paged,
        "telemetry": obs.telemetry_section(),
        "cell_audit": cell_audit,
    }


def run(smoke: bool = False, device: _device.DeviceLike = None, *,
        batch: int = 32, prompt_len: int = 8, max_new: int = 24,
        trace_out: Optional[str] = None) -> dict:
    """The benchmark on `CPU_RANKS` spawned gloo ranks on the CPU, or on
    the cards' ranks (one card: world 1 over NCCL, in this process);
    returns rank 0's record. `check` holds it to the acceptance
    criteria."""
    dev = _device.resolve(device)
    world = CPU_RANKS if dev.type == "cpu" else torch.cuda.device_count()
    return _spawn.run(run_rank, world, device=dev.type, args=(smoke,),
                      kwargs=dict(batch=batch, prompt_len=prompt_len,
                                  max_new=max_new, trace_out=trace_out,
                                  device=dev.type))


def _require(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


def check(rec: dict) -> None:
    """The acceptance criteria: the reference's assertions (the 8-device
    mesh's width cells where they ran)."""
    cells, scaling = rec["cells"], rec["scaling"]
    admission, p = rec["admission"], rec["paged"]
    t, ca = rec["telemetry"], rec["cell_audit"]
    # every multi-device placement keeps per-device cache bytes strictly
    # below the replicated baseline, and the modeled memory-bound
    # tokens/s scales with device count for every arch
    for c in cells:
        if c["devices"] > 1:
            _require(c["cache_bytes_per_device"]
                     < c["cache_bytes_replicated_baseline"], c)
    for s in scaling:
        if s["devices_hi"] >= 8 * s["devices_lo"]:
            _require(s["modeled_speedup"] > 4.0, s)
    # admission is O(prompt): measured work identical across pool sizes
    # (per mesh), and strictly below the replay counterfactual at the
    # larger pools
    by_mesh: dict = {}
    for c in admission:
        by_mesh.setdefault(c["mesh"], []).append(c)
    for mesh_cells in by_mesh.values():
        works = {c["admission_rowsteps"] for c in mesh_cells}
        _require(len(works) == 1,
                 f"admission work varies with pool size: {mesh_cells}")
        big = max(mesh_cells, key=lambda c: c["pool"])
        _require(big["admission_rowsteps"]
                 < big["replay_rowsteps_counterfactual"], big)
    # paged tenancy: >= 2x concurrent tenants at a cache byte budget no
    # larger than the dense pool's, resident bytes fully reclaimed after
    # every drain, nothing new reaching a cell after the warm-up wave
    _require(p["concurrency_gain"] >= 2.0, p)
    _require(p["paged_cache_bytes_total"] <= p["dense_cache_bytes_total"], p)
    _require(p["bytes_in_use"]["post_drain"] == p["bytes_in_use"]["initial"],
             p)
    _require(p["bytes_in_use"]["post_drain_final"]
             == p["bytes_in_use"]["initial"], p)
    _require(p["bytes_in_use"]["peak"] > p["bytes_in_use"]["initial"], p)
    _require(p["recompiles_after_warmup"] == 0, p)
    # telemetry: the registry's admission counters mirror the engines'
    # own accounting exactly, the latency histograms carry percentiles,
    # and the admission cells show up in the recompile map
    _require(t["schema_version"] == obs.SCHEMA_VERSION and t["enabled"], t)
    _require(t["counters"]["serve.admission_rowsteps"] == sum(
        c["admission_rowsteps"] for c in admission)
        + p["admission_rowsteps"], t["counters"])
    _require(t["counters"]["serve.admission_prefills"] == sum(
        c["admission_prefills"] for c in admission)
        + p["admission_prefills"], t["counters"])
    for name in ("serve.ttft_s", "serve.inter_token_s"):
        h = t["histograms"][name]
        _require(h["count"] > 0 and None not in (
            h["p50"], h["p99"], h["p999"]), (name, h))
    _require("serve.decode_step" in t["recompiles"], t["recompiles"])
    sharded = any(c["mesh"] != "1" for c in admission)
    if sharded:
        _require(any(k.startswith("serve.prefill.w")
                     for k in t["recompiles"]), t["recompiles"])
    if cells and all("nccl" in c["device"] for c in cells):
        # the card's allocator (the CPU has none to read)
        _require(t["peak_device_memory_bytes"] > 0, t)
    # the cell audit: every registered serve cell was exercised (its
    # first call recorded) with zero violations — no host transfers, no
    # f64, donations honoured, collectives within the sharded cells'
    # budgets
    _require(ca["n_cells"] > 0, ca)
    _require(ca["violations_total"] == 0, ca)
    _require("serve.decode_step" in ca["cells"], list(ca["cells"]))
    _require(any(k.startswith("serve.prefill") for k in ca["cells"]),
             list(ca["cells"]))
    _require(any(k.startswith("serve.seat") for k in ca["cells"]),
             list(ca["cells"]))


def summary(rec: dict) -> None:
    """The reference's printed lines for the scaling, admission, paged and
    audit sections."""
    for s in rec["scaling"]:
        print(f"[decode_throughput] {s['arch']}: modeled "
              f"{s['modeled_speedup']:.1f}x at {s['devices_hi']} devices "
              f"(cache/dev {s['cache_bytes_per_device_lo']} -> "
              f"{s['cache_bytes_per_device_hi']} B)")
    for c in rec["admission"]:
        print(f"[decode_throughput] admission {c['arch']} mesh={c['mesh']} "
              f"pool={c['pool']:3d}: {c['admission_rowsteps']} rowsteps "
              f"({c['admission_work_per_request']:.0f}/req; replay would "
              f"be {c['replay_rowsteps_counterfactual']})")
    p = rec["paged"]
    print(f"[decode_throughput] paged {p['arch']}: "
          f"{p['paged_peak_concurrent']} vs {p['dense_peak_concurrent']} "
          f"concurrent ({p['concurrency_gain']:.1f}x) at "
          f"{p['paged_cache_bytes_total']} <= "
          f"{p['dense_cache_bytes_total']} cache bytes; bytes in use "
          f"{p['bytes_in_use']['initial']} -> peak "
          f"{p['bytes_in_use']['peak']} -> drained "
          f"{p['bytes_in_use']['post_drain_final']}; "
          f"{p['recompiles_after_warmup']} new signatures after warmup")
    ca = rec["cell_audit"]
    print(f"[decode_throughput] cell audit: {ca['n_cells']} cells, "
          f"{ca['violations_total']} violations")


def main(argv=None, device: _device.DeviceLike = None) -> dict:
    """Parse `argv`, run, print, write `--out`, check; returns the
    record. `device=None` means the card."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="the acceptance cells only")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--out", default=None,
                    help="write the JSON record here (default: nowhere)")
    ap.add_argument("--trace-out", default=None, metavar="PREFIX",
                    help="write rank 0's telemetry trace to PREFIX.jsonl "
                         "(event log) + PREFIX.json (Chrome/Perfetto)")
    args = ap.parse_args(argv)
    rec = run(smoke=args.smoke, device=device, batch=args.batch,
              prompt_len=args.prompt_len, max_new=args.max_new,
              trace_out=args.trace_out)
    summary(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[decode_throughput] -> {args.out}")
    check(rec)
    print("[decode_throughput] all assertions passed")
    return rec


if __name__ == "__main__":
    main()

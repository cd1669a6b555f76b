"""Hillclimb driver: re-count one cell under a named variant and print
the roofline-term deltas vs the recorded baseline (port of
`repro.launch.hillclimb`).

    python -m repro_torch.launch.hillclimb --arch qwen3-8b \\
        --shape decode_32k --variant w8

Variants are (cfg overrides, serve_quant_bits) pairs, the reference's;
results are written next to the baselines with the variant's tag
(`_w8`), so both can be cited. `w8`, `w4` and `kv8w8` serve packed
weights through the `quant_matmul` kernel's wrapper (counted on fake
tensors as a launch); `spe8` / `spe8s` train under the paper's QAT.
The terms are modelled at the H100's data-sheet figures
(`launch.op_analysis`), not measured.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Optional, Sequence

import torch

from repro_torch.launch import dryrun

VARIANTS = {
    # bf16 blockwise scores/softmax (halves score-tensor traffic;
    # accumulators stay f32) — applied via attention.score_dtype
    "smbf16": dict(score_bf16=True),
    # paper-faithful transfer: packed int8/int4 weights (CMUL storage)
    "w8": dict(serve_quant_bits=8),
    "w4": dict(serve_quant_bits=4),
    # beyond-paper: int8 KV cache (quantized storage on the decode-
    # dominant tensor)
    "kv8": dict(overrides={"kv_quant_bits": 8}),
    "kv8w8": dict(serve_quant_bits=8, overrides={"kv_quant_bits": 8}),
    # MoE expert sharding: replicate experts over data (kill the
    # D-contraction all-reduce)
    "moe_tp": dict(overrides={"moe_shard": "tp_only"}),
    # chunked CE (live-logits memory)
    "ce512": dict(overrides={"loss_chunk": 512}),
    "ce512_moe_tp": dict(
        overrides={"loss_chunk": 512, "moe_shard": "tp_only"}
    ),
    # attention block-size sweep
    "blk1024": dict(overrides={"attn_block": 1024}),
    "blk2048": dict(overrides={"attn_block": 2048}),
    # microbatching sweep
    "mb2": dict(overrides={"train_microbatches": 2}),
    "mb4": dict(overrides={"train_microbatches": 4}),
    "mb8": dict(overrides={"train_microbatches": 8}),
    # SPE QAT knobs on the train path (paper technique in training)
    "spe8": dict(spe_bits=8),
    "spe8s": dict(spe_bits=8, spe_sparse=True),
}

TERMS = ("t_compute_s", "t_memory_s", "t_collective_s", "bound_s",
         "roofline_fraction")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Count the variant's cell, write its record, print the deltas;
    returns {"record", "baseline" (None where none is stored),
    "delta_pct"}."""
    ap = dryrun.parser()
    ap.description = __doc__
    ap.add_argument("--variant", required=True, choices=sorted(VARIANTS))
    ap.set_defaults(mesh="single")
    args = ap.parse_args(argv)
    if not (args.arch and args.shape) or args.mesh == "both":
        ap.error("--arch, --shape and one --mesh (single or multi) name "
                 "the cell")

    v = VARIANTS[args.variant]
    with contextlib.ExitStack() as stack:
        if v.get("score_bf16"):
            from repro_torch.models import attention as _A

            stack.enter_context(_A.score_dtype(torch.bfloat16))
        rec = dryrun.run_cell(
            args.arch, args.shape, args.mesh == "multi", args.out,
            spe_bits=v.get("spe_bits"),
            spe_sparse=v.get("spe_sparse", False),
            serve_quant_bits=v.get("serve_quant_bits"),
            overrides={**dryrun.overrides_of(args),
                       **v.get("overrides", {})},
            tag=f"_{args.variant}", reduced=args.reduced, batch=args.batch,
            seq=args.seq, mesh_shape=dryrun._mesh_shape(args.mesh_shape),
            device=args.device,
        )
    # print the before/after against the untagged baseline
    base_fn = os.path.join(
        args.out, rec["mesh_name"], f"{rec['arch']}__{args.shape}.json"
    )
    out = {"record": rec, "baseline": None, "delta_pct": {}}
    if os.path.exists(base_fn):
        with open(base_fn) as f:
            base = json.load(f)
        out["baseline"] = base
        b, n = base["roofline"], rec["roofline"]
        print(f"\n{'term':<16}{'baseline':>12}{'variant':>12}{'delta':>9}")
        for key in TERMS:
            bv, nv = b[key], n[key]
            d = (nv - bv) / bv * 100 if bv else float("nan")
            out["delta_pct"][key] = d
            print(f"{key:<16}{bv:>12.4g}{nv:>12.4g}{d:>8.1f}%")
    return out


if __name__ == "__main__":
    main()

"""Host cost of one kernel wrapper call on the card: `kernels.ops.
quant_matmul` (the route check, the geometry checks, the operand
preparation, the launch's reported cost) against the CUDA function it
dispatches to (`quant_matmul_cuda`, the launch alone), at qwen3-8b's
decode shape (4 rows, K = N = 4096, 8 bits).

    python src/repro_torch/benchmarks/wrapper_host.py [--calls N] [--rounds R]

Run as a file, it measures whichever `repro_torch` is first on
`PYTHONPATH`, so two trees compare in one process each. Each round
enqueues N calls of each back to back (the card runs behind the host)
and reads the host's clock around them; prints the median µs a call of
each over the rounds, and their difference (the wrapper's own cost), as
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def main(argv=None) -> dict:
    import torch

    from repro_torch.core import quant
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as QM

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wrapper_host: no CUDA card")
    dev = torch.device("cuda")
    m, k, n, bits = 4, 4096, 4096, 8
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    q, scale = quant.quantize(w, quant.QuantConfig(bits=bits))
    packed = quant.pack_planes(q, bits)
    x = torch.randn((m, k), generator=gen, device=dev)
    calls = {
        "wrapper": lambda: ops.quant_matmul(x, packed, scale, bits=bits),
        "cuda_function": lambda: QM.quant_matmul_cuda(x, packed, scale,
                                                       bits=bits),
    }
    for fn in calls.values():
        for _ in range(10):
            fn()
    torch.cuda.synchronize()
    us = {name: [] for name in calls}
    for _ in range(args.rounds):
        for name, fn in calls.items():
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn()
            us[name].append((time.perf_counter() - t0) / args.calls * 1e6)
            torch.cuda.synchronize()
    out = {f"{name}_host_us_per_call": statistics.median(v)
           for name, v in us.items()}
    out["wrapper_own_us"] = (out["wrapper_host_us_per_call"]
                             - out["cuda_function_host_us_per_call"])
    out.update(shape=[m, k, n], bits=bits, calls=args.calls,
               rounds=args.rounds, card=torch.cuda.get_device_name(0))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

"""Benchmarks of the port (port of the repository's `benchmarks/`).

- run               : the orchestrator — table1, kernels, ablation and
                      the roofline summary as one `name,us_per_call,derived` CSV
                      (`python -m repro_torch.benchmarks.run`)
- table1            : the paper's Table 1 row from the chip model
- kernels           : the kernel micro-benchmark — nm_spmm, quant_matmul
                      at 8/4/2/1 bits and sparse_conv1d on one VA layer,
                      each checked against its oracle
- ablation          : sparsity x bit-width, 120 training steps a point
- stream_throughput : the streaming fleet's throughput
- roofline_summary  : one row a dry-run record (`launch.dryrun`)
"""

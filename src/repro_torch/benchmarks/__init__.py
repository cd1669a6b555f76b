"""Benchmarks of the port (port of the repository's `benchmarks/`).

- kernels : the kernel micro-benchmark — nm_spmm, quant_matmul at
            8/4/2/1 bits and sparse_conv1d on one VA layer, each checked
            against its oracle (`python -m repro_torch.benchmarks.kernels`)
"""

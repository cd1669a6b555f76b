"""Kernels written by hand for Hopper, with their plain PyTorch twins.

- nm_spmm       : the SPE — balanced select-index sparse matmul
                  (`csrc/nm_spmm.cu`)
- sparse_conv1d : one VA layer fused — SAME-padded windows cut in shared
                  memory + the SPE matmul (`csrc/sparse_conv1d.cu`)
- quant_matmul  : packed 8/4/2/1-bit dequant matmul
                  (`csrc/quant_matmul.cu`)

All three are CUDA C++ for sm_90a.

`ops` holds the public wrappers (batch handling, device dispatch); `ref`
the plain oracles; `_build` compiles `csrc/` at first use. The Pallas
kernels still to be ported are listed in ROADMAP.md.
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]

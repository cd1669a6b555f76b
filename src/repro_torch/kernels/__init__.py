"""Kernels written by hand for Hopper, with their plain PyTorch twins.

- nm_spmm       : the SPE — balanced select-index sparse matmul
                  (`csrc/nm_spmm.cu`)
- sparse_conv1d : one VA layer fused — SAME-padded windows cut in shared
                  memory + the SPE matmul (`csrc/sparse_conv1d.cu`)
- quant_matmul  : packed 8/4/2/1-bit dequant matmul
                  (`csrc/quant_matmul.cu`)
- bitserial     : the CMUL — one sum per two's-complement bit plane of
                  the packed weight, shift-accumulated
                  (`csrc/bitserial_matmul.cu`)

All four are CUDA C++ for sm_90a, one for each Pallas kernel of the JAX
package.

`ops` holds the public wrappers (batch handling, device dispatch); `ref`
the plain oracles; `_build` compiles `csrc/` at first use.
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]

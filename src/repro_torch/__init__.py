"""repro_torch — the PyTorch/CUDA port of the `repro` VA accelerator stack.

A second package beside `repro`: the same subpackage and module names,
the same public layouts (activations NWC `(B, T, C)`, conv weights
`(ks, c_in, c_out)`, compressed layers `(Kk, N)`, scales `(1, N)`), and
plain PyTorch inside. It imports `torch` and numpy only — never `jax`
and nothing of `repro`, whose package import installs jax shims.

Entry points take `device=None`, which means the CUDA card; the CPU is
used only when the caller asks for it (`device="cpu"`), and an entry
point raises rather than fall back when no card is present. Kernels
written by hand for Hopper live in `kernels/csrc/` and are built on
first use (`kernels/_build.py`).
"""

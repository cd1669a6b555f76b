"""Runnable examples of the port (twins of the JAX package's
`examples/`), inside the package so `python -m` finds them."""

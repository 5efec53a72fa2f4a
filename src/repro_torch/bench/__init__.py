"""The port's benchmarks (the counterparts of the JAX package's
``benchmarks/``), each a module run with ``python -m``."""

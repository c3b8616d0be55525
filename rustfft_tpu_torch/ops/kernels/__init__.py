"""Whole-transform kernels: a hand-written CUDA kernel per JAX-package
Pallas kernel on the main path, each beside its plain torch version."""

"""Torch ops of the port: complex helpers, matmul DFT leaves, Cooley-Tukey
stages, and the hand-written CUDA kernels (ops/kernels/)."""

"""Torch ops of the port: complex helpers, matmul DFT leaves, Cooley-Tukey
stages, Good-Thomas, Rader and Bluestein recipes, and the hand-written CUDA
kernels (ops/kernels/)."""

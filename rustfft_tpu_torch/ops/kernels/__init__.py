"""Hand-written CUDA kernels, one per JAX-package Pallas kernel ported so
far, each beside its plain torch version: the whole-transform kernels
(lanepack; fused: the one-pass mid band; large, large2f, large3: two and
three passes), the convolution cores of the prime path (conv: one pass,
conv_radix: two passes) and the permutation (permute)."""

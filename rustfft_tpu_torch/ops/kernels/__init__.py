"""Hand-written CUDA kernels, one per JAX-package Pallas kernel ported so
far, each beside its plain torch version: the whole-transform kernels
(lanepack; dense: the whole DFT as one product; fused: the one-pass mid
band; large, largepad, large2f, large3: two and three passes), the
convolution cores of the prime path (conv: one pass, conv_radix: two
passes, convlarge: the fused large Bluestein) and the permutation
(permute)."""

"""Global configuration for the torch compute path.

The subset of rustfft_tpu/config.py that the port reads.  Every routing
threshold of the JAX package was measured on a TPU and is left out: kernel
routing here is structural (executor.route).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class FftConfig:
    #: Planner: sizes <= this threshold are one dense DFT-matrix matmul leaf
    #: instead of being decomposed (the JAX planner's rule, planner.py:348-351).
    dense_dft_max: int = 256

    #: Use the native C++ plancore (number theory + recipe design + host
    #: tables) when its shared library loads; pure Python otherwise.
    use_native: bool = True

    #: Whole-transform CUDA kernels: "auto" routes every size executor.route
    #: names to its kernel (the plain torch version on CPU tensors); "off"
    #: always runs the torch recipe tree.
    kernels: str = "auto"


#: Module-level config; mutate fields to retune.
config = FftConfig()

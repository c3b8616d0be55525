"""Global configuration for the torch compute path.

The subset of rustfft_tpu/config.py that the port reads.  Every routing
threshold of the JAX package was measured on a TPU and is left out: kernel
routing here is structural (executor.route).  What is kept are switches:
the planner's dense leaf bound, the native plancore, the kernels on or off,
and the JAX package's kernel-variant switches of the two-pass stages, with
the JAX defaults.  Their times on the card are in PERF.md.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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

    #: The "large" route's two stages in the Gauss form
    #: (large.large_col_stage_gauss / large_row_stage_gauss, the port of
    #: rustfft_tpu/config.py:270).  No other route reads it.
    large_gauss: bool = False

    #: The "large" route as K4's 2-D block forms (rustfft_tpu/config.py:195):
    #: on the card the same kernels as the default, bit for bit.
    large_blocks2d: bool = False

    #: The two-pass convolution core's stages in the Gauss form
    #: (conv_radix.make_radix_conv_fn, Rader and Bluestein alike; the port
    #: of rustfft_tpu/config.py:78).  The fused large Bluestein does not read
    #: it.
    conv_radix_gauss: bool = False

    #: The Rader core on the two-pass core reads the raw (batch, p) rows
    #: instead of a copy of x[:, 1:] (needs rader_full_out; the port of
    #: rustfft_tpu/config.py:86).
    rader_in_shift: bool = False

    #: The two-pass Rader core writes the whole DC-first (batch, p) output;
    #: off, the DC bin and the concatenation are torch glue
    #: (rustfft_tpu/config.py:227).
    rader_full_out: bool = True

    def switch_key(self) -> Tuple:
        """Every field a built function or plan bakes in: the key of
        executor.build's cache and of the planners' plan caches."""
        return (self.kernels, self.use_native, self.large_gauss, self.large_blocks2d,
                self.conv_radix_gauss, self.rader_in_shift, self.rader_full_out)


#: Module-level config; mutate fields to retune.
config = FftConfig()

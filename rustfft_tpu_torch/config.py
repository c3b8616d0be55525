"""Global configuration for the torch compute path.

The subset of rustfft_tpu/config.py that the port reads.  The JAX
package's routing thresholds were measured on a TPU: kernel routing here is
structural (executor.route), and the four thresholds the port keeps (the
dense fallback and the hole band) have defaults measured on the card by
tools/torch_planner_rules.py.  The rest are switches: the planner's dense
leaf bound, the native plancore, the kernels on or off, and the JAX
package's kernel-variant switches of the two-pass stages, with the JAX
defaults.  Their times on the card are in PERF.md.
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

    #: The dense route's fallback bound (rustfft_tpu/config.py:58-63): with
    #: the kernels on, every n <= max(dense_dft_max, dense_fallback_max_n)
    #: that no other route serves runs dense_fft.  Off (0): of the 442
    #: sizes of [257, 2042] that no other route serves, dense_fft ran slower
    #: than the planner's path on the convolution cores at all 69 measured
    #: (59 sampled, 10 held out), 1.87x at 257 x 131072 (2.553 against
    #: 1.364 ms, queued device time) to 14.9x at 2038 x 32768 (30.99
    #: against 2.07): its operations grow as n^2
    #: (tools/torch_planner_rules.py; NVIDIA H100 80GB HBM3, 700.00 W).
    dense_fallback_max_n: int = 0

    #: The hole band (rustfft_tpu/config.py:173-186, the JAX planner's
    #: planner.py:363-404): with the kernels on, an odd composite n >=
    #: bconv_misaligned_min_n that large_pad serves runs one Bluestein on
    #: the two-pass core's cluster passes instead, its inner m = r*16384
    #: the smallest >= 2n - 1 (r in 2, 4, 8, 16), when m <=
    #: bconv_misaligned_max_pad * n (executor.hole_band_inner).  Off: with
    #: the JAX settings (8192, 3.5) it takes 15988 odd composites, and of
    #: 21 measured (11 sampled, 10 held out) the Bluestein ran slower than
    #: large_pad at 16, up to 1.93x (18725 x 2048: 3.114 against 1.616 ms,
    #: queued device time; 15625 x 4096 3.026 against 2.378, 59049 x 1024
    #: 3.420 against 2.083).  It ran faster at 16383, 32767, 65535, 28251
    #: and 63535 (1.10-1.24x), where large_pad's chains run Bluestein stages
    #: and m <= 131072, but no pad cap takes those without a loss: 63535
    #: wins at pad 2.06 and 28251 at 2.32 while 131047 (m = 262144) loses
    #: at 2.0003 (0.84x) (tools/torch_planner_rules.py, PLANNER_RULES_GPU.md;
    #: NVIDIA H100 80GB HBM3, 700.00 W).
    bconv_misaligned: bool = False
    bconv_misaligned_min_n: int = 8192
    bconv_misaligned_max_pad: float = 3.5

    def switch_key(self) -> Tuple:
        """Every field a built function or plan bakes in: the key of
        executor.build's cache and of the planners' plan caches."""
        return (self.kernels, self.use_native, self.large_gauss, self.large_blocks2d,
                self.conv_radix_gauss, self.rader_in_shift, self.rader_full_out,
                self.dense_fallback_max_n, self.bconv_misaligned, self.bconv_misaligned_min_n,
                self.bconv_misaligned_max_pad)


#: Module-level config; mutate fields to retune.
config = FftConfig()

"""Public per-algorithm constructors: parity with `rustfft::algorithm`.

Port of rustfft_tpu/algorithm.py.  The reference exposes its composite
algorithms as directly constructible types implementing `Fft<T>`
(src/algorithm/mod.rs:1-21): `Dft`, `Radix4`, `Radix3`, `MixedRadix(+Small)`,
`GoodThomasAlgorithm(+Small)`, `RadersAlgorithm`, `BluesteinsAlgorithm`, plus
the `butterflies` module.  Users who want a specific decomposition (bypassing
the planner) build these by hand; each composite takes pre-built inner FFTs,
as the reference constructors take `Arc<dyn Fft<T>>`.

Every constructor returns a pinned `FftPlan` (plan.py): the literal recipe
runs, with no whole-transform kernel and no convolution core substituted by
the executor, so e.g. `Dft` stays an independent full-precision oracle.
Good-Thomas nodes keep their permute gathers (ops/kernels/permute.py), as in
the JAX package.  Planner-built plans are the performance path.

The leaf constructors take a device (the card unless the caller passes
device="cpu"); the composite constructors take theirs from the inner plans,
which must share it.
"""
from __future__ import annotations

import math

import numpy as np

from . import math_utils, recipes
from .common import FftDirection
from .plan import FftPlan
from .planner import BUTTERFLY_SIZES


def _leaf(n: int) -> recipes.Recipe:
    return recipes.Butterfly(n) if n in BUTTERFLY_SIZES else recipes.Dft(n)


def _check_inner(*plans: FftPlan):
    """(direction, dtype, device) shared by the inner plans."""
    d0, t0, dev0 = plans[0].fft_direction(), plans[0].dtype, plans[0].device
    for p in plans[1:]:
        if p.fft_direction() is not d0:
            raise ValueError("inner FFTs must share a direction")
        if p.dtype != t0:
            raise ValueError("inner FFTs must share a dtype")
        if p.device != dev0:
            raise ValueError(f"inner FFTs must share a device, got {dev0} and {p.device}")
    return d0, t0, dev0


def _pinned(recipe: recipes.Recipe, direction, dtype, device) -> FftPlan:
    return FftPlan(recipe, direction, dtype, device, pinned=True)


def Dft(length: int, direction: FftDirection, dtype=np.complex64, device="cuda") -> FftPlan:
    """Naive O(n^2) DFT, the reference oracle (algorithm/dft.rs:22-81): one
    matmul against the n x n DFT matrix."""
    return _pinned(recipes.Dft(length), direction, dtype, device)


def Butterfly(length: int, direction: FftDirection, dtype=np.complex64,
              device="cuda") -> FftPlan:
    """Fixed-size base kernel (algorithm/butterflies.rs), sizes 2..32."""
    if length not in BUTTERFLY_SIZES:
        raise ValueError(
            f"no butterfly of size {length}; reference set is "
            f"{sorted(BUTTERFLY_SIZES)} (plan.rs:610-634)"
        )
    return _pinned(recipes.Butterfly(length), direction, dtype, device)


def Radix4(length: int, direction: FftDirection, dtype=np.complex64, device="cuda") -> FftPlan:
    """Power-of-two FFT (algorithm/radix4.rs).

    Base selection mirrors radix4.rs:50-63: lengths up to 8 run directly;
    larger use base 16 (even exponent) or 32 (odd), with radix-4 layers above.
    """
    if length & (length - 1):
        raise ValueError(f"Radix4 requires a power-of-two length, got {length}")
    bits = length.bit_length() - 1
    if bits <= 3:
        return _pinned(_leaf(length), direction, dtype, device)
    base = 16 if bits % 2 == 0 else 32
    k = (bits - base.bit_length() + 1) // 2
    return _pinned(recipes.Radix4(k, recipes.Butterfly(base)), direction, dtype, device)


def Radix3(length: int, direction: FftDirection, dtype=np.complex64, device="cuda") -> FftPlan:
    """Power-of-three FFT (algorithm/radix3.rs); bases {1, 3, 9, 27}."""
    n, k = length, 0
    while n % 3 == 0:
        n //= 3
        k += 1
    if n != 1:
        raise ValueError(f"Radix3 requires a power-of-three length, got {length}")
    if length <= 27:
        return _pinned(_leaf(length), direction, dtype, device)
    base = recipes.Butterfly(27)
    return _pinned(recipes.RadixN((3,) * (k - 3), base), direction, dtype, device)


def MixedRadix(width_fft: FftPlan, height_fft: FftPlan) -> FftPlan:
    """Cooley-Tukey n = w*h six-step (algorithm/mixed_radix.rs:35-238)."""
    recipe = recipes.MixedRadix(width_fft.recipe, height_fft.recipe)
    return _pinned(recipe, *_check_inner(width_fft, height_fft))


def MixedRadixSmall(width_fft: FftPlan, height_fft: FftPlan) -> FftPlan:
    """MixedRadix variant for butterfly-sized factors (mixed_radix.rs:266-507)."""
    recipe = recipes.MixedRadixSmall(width_fft.recipe, height_fft.recipe)
    return _pinned(recipe, *_check_inner(width_fft, height_fft))


def _check_coprime(name: str, width_fft: FftPlan, height_fft: FftPlan) -> None:
    if math.gcd(len(width_fft), len(height_fft)) != 1:
        raise ValueError(
            f"{name} requires coprime inner lengths, got "
            f"{len(width_fft)} and {len(height_fft)}"
        )


def GoodThomasAlgorithm(width_fft: FftPlan, height_fft: FftPlan) -> FftPlan:
    """Prime-Factor Algorithm for coprime w*h (good_thomas_algorithm.rs:40-311)."""
    _check_coprime("GoodThomasAlgorithm", width_fft, height_fft)
    recipe = recipes.GoodThomas(width_fft.recipe, height_fft.recipe)
    return _pinned(recipe, *_check_inner(width_fft, height_fft))


def GoodThomasAlgorithmSmall(width_fft: FftPlan, height_fft: FftPlan) -> FftPlan:
    """Good-Thomas with precomputed maps (good_thomas_algorithm.rs:344-649)."""
    _check_coprime("GoodThomasAlgorithmSmall", width_fft, height_fft)
    recipe = recipes.GoodThomasSmall(width_fft.recipe, height_fft.recipe)
    return _pinned(recipe, *_check_inner(width_fft, height_fft))


def RadersAlgorithm(inner_fft: FftPlan) -> FftPlan:
    """Prime-length FFT via cyclic convolution (raders_algorithm.rs:41-330).

    `inner_fft` must have length p-1 for the (prime) target length p, the
    same contract as the reference constructor.
    """
    p = len(inner_fft) + 1
    if not math_utils.is_prime(p):
        raise ValueError(
            f"RadersAlgorithm requires inner length + 1 prime, got {p}"
        )
    return _pinned(recipes.Raders(inner_fft.recipe), *_check_inner(inner_fft))


def BluesteinsAlgorithm(length: int, inner_fft: FftPlan) -> FftPlan:
    """Arbitrary-length FFT via chirp-z (bluesteins_algorithm.rs:39-226).

    `inner_fft` may be any FFT of length >= 2*length - 1.
    """
    if len(inner_fft) < 2 * length - 1:
        raise ValueError(
            f"BluesteinsAlgorithm inner length {len(inner_fft)} < "
            f"2*{length}-1 (bluesteins_algorithm.rs:39)"
        )
    return _pinned(recipes.Bluesteins(length, inner_fft.recipe), *_check_inner(inner_fft))

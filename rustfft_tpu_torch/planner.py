"""Planners: recipe design + plan construction with caching.

Port of rustfft_tpu/planner.py.  `FftPlannerScalar` reproduces the reference
scalar planner's decision tree exactly (src/plan.rs:270-665).
`FftPlannerGpu` keeps the JAX package's cost-model recipe rules that do not
depend on TPU measurements: a dense DFT leaf up to config.dense_dft_max, the
near-balanced composite split (planner.py:348-351, 469-514), and, with the
c64 kernels on, FftPlannerTpu's prime and awkward-composite rules
(planner.py:355-362, 413-467, 516-569) where "aligned" reads "a convolution
core of the port serves m with register stages only" (conv.conv_aligned).
Whole-transform kernels are substituted by the executor, not by the recipe.
`FftPlanner` delegates to `FftPlannerGpu`.  Every planner names the device
that numpy buffers are computed on: the card unless the caller passes
device="cpu".
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import recipes
from .common import FftDirection, canonical_complex_dtype
from .config import config
from .math_utils import PrimeFactors
from .ops.kernels import conv
from .plan import FftPlan

#: reference: plan.rs:127-129
MAX_RADIXN_FACTOR = 7
MAX_RADER_PRIME_FACTOR = 23

#: reference: plan.rs:610-634
BUTTERFLY_SIZES = frozenset(
    {2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 16, 17, 19, 23, 24, 27, 29, 31, 32}
)

#: reference: plan.rs:433-435 (note: excludes 12, includes 13)
_BUTTERFLY_PRODUCT_SIZES = (
    2, 3, 4, 5, 6, 7, 8, 9, 11, 13, 16, 17, 19, 23, 24, 27, 29, 31, 32,
)


class FftCache:
    """(len, direction) -> FftPlan, separate forward/inverse maps.

    reference: src/fft_cache.rs:5-39.
    """

    def __init__(self) -> None:
        self._forward: Dict[int, FftPlan] = {}
        self._inverse: Dict[int, FftPlan] = {}

    def _map(self, direction: FftDirection) -> Dict[int, FftPlan]:
        return self._forward if direction is FftDirection.FORWARD else self._inverse

    def get(self, length: int, direction: FftDirection) -> Optional[FftPlan]:
        return self._map(direction).get(length)

    def insert(self, plan: FftPlan) -> None:
        self._map(plan.fft_direction())[len(plan)] = plan

    def contains_fft(self, length: int, direction: FftDirection) -> bool:
        return length in self._map(direction)


class _PlannerBase:
    """Shared recipe-cache / plan-cache plumbing (plan.rs:270-335)."""

    #: subclasses with a native (C++ plancore) recipe designer set this
    _native_design = False

    def __init__(self, dtype=np.complex64, device="cuda") -> None:
        self.dtype = canonical_complex_dtype(dtype)
        self.device = torch.device(device)
        # one FftCache per config state (see _recipe_cache_key)
        self._algorithm_caches: Dict[Tuple, FftCache] = {}
        self.recipe_cache: Dict[Tuple, recipes.Recipe] = {}

    @property
    def algorithm_cache(self) -> FftCache:
        """The plan cache for the *current* config state: the recipe
        design's key and every switch a built plan bakes in."""
        key = self._recipe_cache_key() + config.switch_key()
        cache = self._algorithm_caches.get(key)
        if cache is None:
            cache = self._algorithm_caches[key] = FftCache()
        return cache

    # -- public API (plan.rs:289-309) --
    def plan_fft(self, length: int, direction: FftDirection) -> FftPlan:
        recipe = self.design_fft_for_len(length)
        cache = self.algorithm_cache
        cached = cache.get(length, direction)
        if cached is not None:
            return cached
        plan = FftPlan(recipe, direction, self.dtype, self.device)
        cache.insert(plan)
        return plan

    def plan_fft_forward(self, length: int) -> FftPlan:
        return self.plan_fft(length, FftDirection.FORWARD)

    def plan_fft_inverse(self, length: int) -> FftPlan:
        return self.plan_fft(length, FftDirection.INVERSE)

    def _recipe_cache_key(self) -> Tuple:
        """Config state the recipe design depends on."""
        if self._native_design:
            return (bool(config.use_native),)
        return ()

    # -- recipe design entry (plan.rs:312-323) --
    def design_fft_for_len(self, length: int) -> recipes.Recipe:
        if length < 0:
            raise ValueError(f"FFT length must be >= 0, got {length}")
        if length < 2:
            return recipes.Dft(length)
        key = (length,) + self._recipe_cache_key()
        cached = self.recipe_cache.get(key)
        if cached is not None:
            return cached
        recipe = None
        if self._native_design and config.use_native:
            from . import native

            recipe = native.design_recipe(length)
        if recipe is None:
            factors = PrimeFactors.compute(length)
            recipe = self.design_fft_with_factors(length, factors)
        self.recipe_cache[key] = recipe
        return recipe

    def design_fft_with_factors(self, length: int, factors: PrimeFactors) -> recipes.Recipe:
        raise NotImplementedError

    def _reference_prime_recipe(self, length: int, raders_factors: PrimeFactors) -> recipes.Recipe:
        """The reference Rader's-vs-Bluestein's rule (plan.rs:636-665)."""
        if any(
            f.value > MAX_RADER_PRIME_FACTOR
            for f in raders_factors.get_other_factors()
        ):
            inner_len = min(_bluestein_inner_candidates(length))
            return recipes.Bluesteins(length, self.design_fft_for_len(inner_len))
        inner_fft = self.design_fft_with_factors(length - 1, raders_factors)
        return recipes.Raders(inner_fft)

    def _design_prime(self, length: int) -> recipes.Recipe:
        return self._reference_prime_recipe(length, PrimeFactors.compute(length - 1))


def _bluestein_inner_candidates(length: int) -> Tuple[int, ...]:
    """Valid Bluestein inner sizes >= 2n-1: next pow2, and 3*2^(k-2) when it
    still clears the bound (plan.rs:645-657)."""
    min_inner = 2 * length - 1
    pow2 = 1 << (min_inner - 1).bit_length()
    three = pow2 // 4 * 3
    return (pow2, three) if three >= min_inner else (pow2,)


def _smooth_inner_candidates(length: int) -> Tuple[int, ...]:
    """The Bluestein inner sizes of the 2^a*3^b family >= 2n-1, ascending:
    the reference's candidates and every 2^a*3^b in [2n-1, 2*(2n-1)) (beyond
    2x the bound the pow2 candidate is always at least as small)."""
    candidates = set(_bluestein_inner_candidates(length))
    min_inner = 2 * length - 1
    p3 = 1
    while p3 < 2 * min_inner:
        m = p3
        while m < min_inner:
            m *= 2
        if m < 2 * min_inner:
            candidates.add(m)
        p3 *= 3
    return tuple(sorted(candidates))


def routed_bluestein_inner(length: int, dtype) -> Optional[int]:
    """The smallest 2^a*3^b Bluestein inner m >= 2n-1 whose core runs a fast
    form (FAST_FORMS: K15's tile form or K14's cluster passes,
    executor.core_form), or None: the port's reading of the JAX planner's
    _routed_bluestein_inner (planner.py:552-569), whose "a fused tier
    serves m" reads here as a core form that the card runs near
    torch.fft's time.  746497 -> 1572864 (K15's tile form at Q = 6144),
    88589 -> 262144 (the cluster passes at r = 16).  The planner takes it
    for the primes whose inner runs K14's four stages (prime_rule_inner)."""
    return next((m for m in _smooth_inner_candidates(length) if _routed_core(m, dtype)), None)


#: the core forms routed_bluestein_inner takes (executor.CORE_FORMS)
FAST_FORMS = ("K15 tile form", "K14 cluster passes")

#: the Q of K15's tile form (m = 256 * Q) that the prime rule and the
#: composite rule were measured on and take; the tile form's later Q (144 ..
#: 1296, 12288, 24576) run the Bluesteins the planner already gives those
#: inner lengths and draw no prime or composite from another recipe
ROUTED_TILE_Q = (1536, 1728, 2048, 2304, 3072, 4096, 6144, 8192)


def _routed_core(m: int, dtype) -> bool:
    """A Bluestein of inner length m runs a core routed_bluestein_inner
    takes: a FAST_FORMS form, K15's tile form only at ROUTED_TILE_Q."""
    from . import executor

    form = executor.core_form("bluestein", m, dtype)
    if form == FAST_FORMS[0]:
        return m % 256 == 0 and m // 256 in ROUTED_TILE_Q
    return form in FAST_FORMS


def prime_rule_inner(length: int, recipe: recipes.Recipe, dtype) -> Optional[int]:
    """The prime rule: the inner length of the Bluestein the planner takes
    for the prime n in place of `recipe` (the Raders or Bluesteins of the
    convolution-core rules), or None to keep it.  Where the recipe's inner
    runs K14's four stages, the fast-form inner routed_bluestein_inner:
    11228 of the primes of [8192, 2^20] (604 Raders, 10624 Bluesteins;
    tools/torch_prime_cores.py), 8000 onto the cluster passes and 3228 onto
    K15's tile form, their inner 1.05-3.90x the one they leave.  The card
    measured the new recipe faster at all 86 primes timed (67 sampled, 19
    held out), 1.11x at 40961 x 1024 (3.314 against 3.688 ms, queued
    device time) to 3.12x at 719951 x 64 (3.089 against 9.633); 746497 x
    64 3.119 against 7.551 (tools/torch_planner_rules.py; NVIDIA H100 80GB
    HBM3, 700.00 W)."""
    from . import executor

    kind = "rader" if isinstance(recipe, recipes.Raders) else "bluestein"
    if executor.core_form(kind, recipe.inner.length, dtype) != "K14 four stages":
        return None
    return routed_bluestein_inner(length, dtype)


class FftPlannerScalar(_PlannerBase):
    """Exact port of the reference scalar planner's decision tree
    (src/plan.rs:270-665): butterfly -> prime -> butterfly product -> RadixN
    -> partitioned MixedRadix.  Recipe design runs in the native plancore
    when it loads; this Python tree is the fallback and the specification."""

    _native_design = True

    def design_fft_with_factors(self, length: int, factors: PrimeFactors) -> recipes.Recipe:
        butterfly = self._design_butterfly_algorithm(length)
        if butterfly is not None:
            return butterfly
        if factors.is_prime():
            return self._design_prime(length)
        product = self._design_butterfly_product(length)
        if product is not None:
            return product
        if factors.has_factors_leq(MAX_RADIXN_FACTOR):
            return self._design_radixn(factors)
        left_factors, right_factors = factors.partition_factors()
        return self._design_mixed_radix(left_factors, right_factors)

    def _design_butterfly_algorithm(self, length: int) -> Optional[recipes.Recipe]:
        """reference: plan.rs:610-634."""
        if length in BUTTERFLY_SIZES:
            return recipes.Butterfly(length)
        return None

    def _design_butterfly_product(self, length: int) -> Optional[recipes.Recipe]:
        """n = b1*b2 with both butterflies, min-sum pair (plan.rs:427-472)."""
        if length > 992 or (length & (length - 1)) == 0:
            return None
        limit = math.ceil(math.sqrt(length)) + 1
        min_sum = None
        found: Optional[Tuple[int, int]] = None
        for left in _BUTTERFLY_PRODUCT_SIZES:
            if left >= limit:
                break
            right = length // left
            if left * right == length and right in _BUTTERFLY_PRODUCT_SIZES:
                s = left + right
                if min_sum is None or s < min_sum:
                    min_sum = s
                    found = (left, right)
        if found is None:
            return None
        left_len, right_len = found
        left_fft = self.design_fft_for_len(left_len)
        right_fft = self.design_fft_for_len(right_len)
        if math.gcd(left_len, right_len) == 1:
            return recipes.GoodThomasSmall(left_fft, right_fft)
        return recipes.MixedRadixSmall(left_fft, right_fft)

    def _design_mixed_radix(self, left_factors: PrimeFactors, right_factors: PrimeFactors) -> recipes.Recipe:
        """reference: plan.rs:474-506."""
        left_len = left_factors.get_product()
        right_len = right_factors.get_product()
        left_fft = self.design_fft_with_factors(left_len, left_factors)
        right_fft = self.design_fft_with_factors(right_len, right_factors)
        if left_len < 31 and right_len < 31:
            if math.gcd(left_len, right_len) == 1:
                return recipes.GoodThomasSmall(left_fft, right_fft)
            return recipes.MixedRadixSmall(left_fft, right_fft)
        return recipes.MixedRadix(left_fft, right_fft)

    def _design_radixn(self, factors: PrimeFactors) -> recipes.Recipe:
        """Base-butterfly choice + Radix4/RadixN chain (plan.rs:508-607)."""
        p2 = factors.get_power_of_two()
        p3 = factors.get_power_of_three()
        p5 = next((f.count for f in factors.get_other_factors() if f.value == 5), 0)
        p7 = next((f.count for f in factors.get_other_factors() if f.value == 7), 0)

        if factors.has_factors_gt(MAX_RADIXN_FACTOR):
            base_len = factors.product_above(MAX_RADIXN_FACTOR)
        elif p7 == 0 and p5 == 0 and p3 < 2:
            if p3 == 0:
                assert p2 > 5  # butterflies catch smaller powers of two
                base_len = 8 if p2 % 2 == 1 else 16
            else:
                assert p2 > 3
                base_len = 24 if p2 % 2 == 1 else 12
        elif p2 > 0 and p3 > 0:
            excess_p2 = max(p2 - p3, 0)
            base_len = {0: 6, 1: 12}.get(excess_p2, 24)
        elif p3 > 2:
            base_len = 27
        elif p3 > 1:
            base_len = 9
        elif p7 > 0:
            base_len = 7
        else:
            assert p5 > 0
            base_len = 5

        base_fft = self.design_fft_for_len(base_len)
        cross_len = factors.get_product() // base_len

        # Radix4 when the cross is 4^k (plan.rs:568-573)
        if cross_len & (cross_len - 1) == 0:
            cross_bits = cross_len.bit_length() - 1
            if cross_bits % 2 == 0:
                return recipes.Radix4(cross_bits // 2, base_fft)

        # RadixN factor list ordered 7,6,5,3,2,4s-last (plan.rs:575-606)
        factor_list = []
        for f in (7, 6, 5, 3):
            while cross_len % f == 0:
                cross_len //= f
                factor_list.append(f)
        assert cross_len & (cross_len - 1) == 0
        cross_bits = cross_len.bit_length() - 1
        if cross_bits % 2 == 1:
            factor_list.append(2)
        factor_list.extend([4] * (cross_bits // 2))
        return recipes.RadixN(tuple(factor_list), base_fft)


class FftPlannerGpu(_PlannerBase):
    """Cost-model planner for the torch path.

    * n <= config.dense_dft_max: one dense DFT-matrix matmul leaf.
    * With the c64 kernels on (config.kernels == "auto"):
      - prime n: Rader's when a convolution core serves n-1 with register
        stages only (conv.conv_aligned), else Bluestein's with the inner
        `_conv_inner` picks, else the reference rule; then the prime rule
        (prime_rule_inner): where that recipe's inner runs K14's four
        stages, Bluestein's on the inner routed_bluestein_inner finds (the
        JAX planner's third prime rule, planner.py:533-549);
      - an odd composite of the hole band (executor.hole_band_inner, the
        JAX planner's planner.py:363-381, on with config.bconv_misaligned):
        one whole-n Bluestein's on the two-pass core's cluster passes;
      - composite n with a prime factor above dense_dft_max (1234 = 2*617):
        one whole-n Bluestein's when `_conv_inner` finds an inner; then the
        composite rule (`_composite_way`): where that Bluestein runs K14's
        four stages and no route serves n, the cheaper by split_costs.py's
        tables of the Bluestein on routed_bluestein_inner and the split
        below (the 64210 such composites of [8192, 2^20): 25739 onto the
        cluster passes, 18396 onto K15's tile form, 20075 split;
        tools/torch_prime_cores.py --composites).
    * composite n: near-balanced split n = p*q (largest divisor <= sqrt(n)),
      recursing on both halves; the executor swaps every subtree whose length
      executor.route names for that whole-transform kernel.
    * otherwise (kernels off, c128) primes take the reference's
      Rader's-vs-Bluestein's rule: the JAX package's recipes with Pallas off.

    The card's measurements of the rules are tools/torch_planner_rules.py's
    (PERF.md).
    """

    def _recipe_cache_key(self) -> Tuple:
        return (config.dense_dft_max, config.kernels, config.dense_fallback_max_n,
                config.bconv_misaligned, config.bconv_misaligned_min_n,
                config.bconv_misaligned_max_pad)

    def _conv_rules(self) -> bool:
        return config.kernels == "auto" and self.dtype == np.complex64

    def design_fft_with_factors(self, length: int, factors: PrimeFactors) -> recipes.Recipe:
        if length <= config.dense_dft_max:
            return recipes.Dft(length)
        if factors.is_prime():
            return self._design_prime(length)
        if self._conv_rules():
            recipe = self._conv_composite_recipe(length, factors)
            if recipe is not None:
                way = self._composite_way(length, factors, recipe)
                if way == "bluestein":
                    m = routed_bluestein_inner(length, self.dtype)
                    return recipes.Bluesteins(length, self.design_fft_for_len(m))
                return recipe if way is None else self._split(length, factors)
        return self._split(length, factors)

    def _split(self, length: int, factors: PrimeFactors) -> recipes.MixedRadix:
        """The near-balanced split n = p * q, both halves designed."""
        p = self._choose_left_factor(length, factors)
        return recipes.MixedRadix(self.design_fft_for_len(p),
                                  self.design_fft_for_len(length // p))

    def composite_way(self, length: int) -> Optional[str]:
        """The composite rule's way at n (`_composite_way`): "split",
        "bluestein", or None where the rule leaves the plan alone."""
        factors = PrimeFactors.compute(length)
        if length <= config.dense_dft_max or factors.is_prime() or not self._conv_rules():
            return None
        recipe = self._conv_composite_recipe(length, factors)
        return None if recipe is None else self._composite_way(length, factors, recipe)

    def _composite_way(self, length: int, factors: PrimeFactors,
                       recipe: recipes.Bluesteins) -> Optional[str]:
        """R4, the composite rule, on a composite's whole-n Bluestein
        (`_conv_composite_recipe`): None (keep it) unless it runs K14's four
        stages and no route serves n (the hole band's inner runs the cluster
        passes, so its sizes keep theirs); else the cheaper by
        split_costs.py's H100 tables (`composite_costs`) of "bluestein",
        the Bluestein on routed_bluestein_inner's m_a (K14's cluster passes
        or K15's tile form), and "split", the near-balanced split (_split):
        p transforms of its prime half's core and n elements of the CT
        glue.  The JAX planner's core preference (_aligned_conv_inner,
        planner.py:413-468: a larger radix-core inner over a smaller
        dense-core one, else the split) read as the card's costs; the split
        measured within 1.3% of its glue plus its half at 150 sizes, and
        the way this takes the faster, or level, at 20 of 20 sizes held out
        from the tables (tools/torch_planner_rules.py; NVIDIA H100 80GB
        HBM3, 700.00 W)."""
        from . import executor

        m = recipe.inner.length
        if (executor.core_form("bluestein", m, self.dtype) != "K14 four stages"
                or executor.route(length, self.dtype) is not None):
            return None
        blue, split = self.composite_costs(length, factors)
        if blue is None:
            return None
        return "split" if split is not None and split < blue else "bluestein"

    def composite_costs(self, length: int,
                        factors: PrimeFactors) -> Tuple[Optional[float], Optional[float]]:
        """(the Bluestein's, the split's) ns a transform at n by
        split_costs.py's tables, each None where they price no such path:
        the Bluestein on routed_bluestein_inner, and the near-balanced split
        where its DFT_p is a matmul leaf (p <= dense_dft_max) and its prime
        half a Raders or Bluesteins that no route serves."""
        from . import executor, split_costs

        m_a = routed_bluestein_inner(length, self.dtype)
        blue = split_costs.core_ns("bluestein", m_a) if m_a else None
        p = self._choose_left_factor(length, factors)
        half = self.design_fft_for_len(length // p)
        if (p > config.dense_dft_max or not isinstance(half, (recipes.Raders, recipes.Bluesteins))
                or executor.route(half.length, self.dtype) is not None):
            return blue, None
        kind = "rader" if isinstance(half, recipes.Raders) else "bluestein"
        return blue, split_costs.split_ns(p, length, kind, half.inner.length)

    def _design_prime(self, length: int) -> recipes.Recipe:
        """The recipe _conv_prime_recipe gives, or with the c64 kernels on
        the prime rule's Bluestein in its place (prime_rule_inner: where
        its inner runs K14's four stages, a fast core form's)."""
        recipe = self._conv_prime_recipe(length)
        if self._conv_rules() and isinstance(recipe, (recipes.Raders, recipes.Bluesteins)):
            m = prime_rule_inner(length, recipe, self.dtype)
            if m is not None:
                return recipes.Bluesteins(length, self.design_fft_for_len(m))
        return recipe

    def _conv_prime_recipe(self, length: int) -> recipes.Recipe:
        """With the c64 kernels on, Rader's on an aligned n-1, else
        Bluestein's on an aligned inner (_conv_inner); else, and with the
        kernels off, the reference rule."""
        raders_factors = PrimeFactors.compute(length - 1)
        if self._conv_rules():
            if conv.conv_aligned(length - 1, self.dtype):
                return recipes.Raders(self.design_fft_with_factors(length - 1, raders_factors))
            m = self._conv_inner(length)
            if m is not None:
                return recipes.Bluesteins(length, self.design_fft_for_len(m))
        return self._reference_prime_recipe(length, raders_factors)

    def _conv_composite_recipe(self, length: int,
                               factors: Optional[PrimeFactors] = None) -> Optional[recipes.Recipe]:
        """With the c64 kernels on, the whole-n Bluestein's of a composite:
        the hole band's (executor.hole_band_inner), else, for a composite
        with a prime factor above dense_dft_max, the one on the inner
        `_conv_inner` finds; None where neither applies (the split)."""
        from . import executor

        factors = factors or PrimeFactors.compute(length)
        # the hole band before the awkward-composite rule: route gives
        # these sizes no route, so the recipe's m is the one that runs
        m = executor.hole_band_inner(length, self.dtype)
        if m is None and factors.has_factors_gt(config.dense_dft_max):
            m = self._conv_inner(length)
        return None if m is None else recipes.Bluesteins(length, self.design_fft_for_len(m))

    def _conv_inner(self, length: int) -> Optional[int]:
        """The smallest Bluestein inner m >= 2n-1 of the 2^a*3^b family (JAX
        planner.py:425-436) that a convolution core serves with register
        stages only (conv.conv_aligned), or None.  1234 takes 3072 =
        (16, 16, 12), not 2592 = (18, 16, 9)."""
        return next((m for m in _smooth_inner_candidates(length)
                     if conv.conv_aligned(m, self.dtype)), None)

    @staticmethod
    def _choose_left_factor(length: int, factors: PrimeFactors) -> int:
        """Largest divisor <= sqrt(n), enumerated from the factorization."""
        target = math.isqrt(length)
        primes = []
        if factors.get_power_of_two():
            primes.append((2, factors.get_power_of_two()))
        if factors.get_power_of_three():
            primes.append((3, factors.get_power_of_three()))
        primes.extend((f.value, f.count) for f in factors.get_other_factors())

        best = 1

        def walk(i: int, divisor: int) -> None:
            nonlocal best
            if divisor > best:
                best = divisor
            if i == len(primes):
                return
            value, count = primes[i]
            d = divisor
            walk(i + 1, d)
            for _ in range(count):
                d *= value
                if d > target:
                    break
                walk(i + 1, d)

        walk(0, 1)
        assert best > 1, length
        return best


class FftPlanner(_PlannerBase):
    """Auto-dispatching planner (reference: plan.rs:67-126): delegates to
    FftPlannerGpu.  `device` (default "cuda") is where numpy buffers are
    computed; torch tensors are computed on their own device."""

    _recipe_cache_key = FftPlannerGpu._recipe_cache_key

    def __init__(self, dtype=np.complex64, device="cuda") -> None:
        super().__init__(dtype, device)
        self._inner = FftPlannerGpu(dtype, device)
        # share caches so plan_fft and design_fft_for_len agree
        self._inner._algorithm_caches = self._algorithm_caches
        self._inner.recipe_cache = self.recipe_cache

    def design_fft_with_factors(self, length: int, factors: PrimeFactors) -> recipes.Recipe:
        return self._inner.design_fft_with_factors(length, factors)

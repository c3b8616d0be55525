"""Number theory used by the planner.

Copy of rustfft_tpu/math_utils.py (reference: src/math_utils.rs), limited to
what the planner, the Rader tables and the native parity checks read.  Python integers are
arbitrary precision, so the reference's u64/u128 strength-reduction tricks are
unnecessary; the *semantics* (which factors a number reports, how factor sets
partition) are identical because recipe parity depends on them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for the 64-bit range."""
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def modular_exponent(base: int, exponent: int, modulo: int) -> int:
    """reference: src/math_utils.rs:23-37."""
    return pow(base, exponent, modulo)


def distinct_prime_factors(n: int) -> List[int]:
    """All prime factors of n without duplicates (reference: src/math_utils.rs:40-74)."""
    result: List[int] = []
    if n % 2 == 0:
        while n % 2 == 0:
            n //= 2
        result.append(2)
    if n > 1:
        divisor = 3
        limit = math.isqrt(n) + 1
        while divisor < limit:
            if n % divisor == 0:
                while n % divisor == 0:
                    n //= divisor
                result.append(divisor)
                limit = math.isqrt(n) + 1
            divisor += 2
        if n > 1:
            result.append(n)
    return result


def primitive_root(prime: int) -> Optional[int]:
    """Smallest primitive root modulo a prime (reference: src/math_utils.rs:3-20)."""
    test_exponents = [(prime - 1) // f for f in distinct_prime_factors(prime - 1)]
    for candidate in range(2, prime):
        if all(pow(candidate, e, prime) != 1 for e in test_exponents):
            return candidate
    return None


def extended_gcd(a: int, b: int) -> Tuple[int, int, int]:
    """Return (g, x, y) with a*x + b*y = g = gcd(a, b)."""
    old_r, r = a, b
    old_s, s = 1, 0
    old_t, t = 0, 1
    while r != 0:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
        old_t, t = t, old_t - q * t
    return old_r, old_s, old_t


def mod_inverse(a: int, m: int) -> int:
    """Multiplicative inverse of a mod m (reference: raders_algorithm.rs:79-86)."""
    g, x, _ = extended_gcd(a, m)
    if g != 1:
        raise ValueError(f"{a} has no inverse mod {m}")
    return x % m


@dataclass(frozen=True)
class PrimeFactor:
    """reference: src/math_utils.rs:76-80."""

    value: int
    count: int


class PrimeFactors:
    """Full prime factorization with powers of 2 and 3 split out.

    Semantics mirror reference src/math_utils.rs:82-368 exactly — the planner's
    decision tree keys off these accessors (has_factors_leq/gt, product_above,
    partition_factors).
    """

    __slots__ = (
        "other_factors",
        "n",
        "power_two",
        "power_three",
        "total_factor_count",
        "distinct_factor_count",
    )

    def __init__(self) -> None:
        self.other_factors: List[PrimeFactor] = []
        self.n = 0
        self.power_two = 0
        self.power_three = 0
        self.total_factor_count = 0
        self.distinct_factor_count = 0

    @classmethod
    def compute(cls, n: int) -> "PrimeFactors":
        self = cls()
        self.n = n
        p2 = (n & -n).bit_length() - 1 if n > 0 else 0
        self.power_two = p2
        self.total_factor_count += p2
        n >>= p2
        if p2 > 0:
            self.distinct_factor_count += 1
        while n % 3 == 0:
            self.power_three += 1
            n //= 3
        self.total_factor_count += self.power_three
        if self.power_three > 0:
            self.distinct_factor_count += 1
        # remaining odd factors >= 5 by trial division
        if n > 1:
            divisor = 5
            limit = math.isqrt(n) + 1
            while divisor < limit:
                count = 0
                while n % divisor == 0:
                    n //= divisor
                    count += 1
                if count > 0:
                    self.other_factors.append(PrimeFactor(divisor, count))
                    self.total_factor_count += count
                    self.distinct_factor_count += 1
                    limit = math.isqrt(n) + 1
                divisor += 2
            if n > 1:
                self.other_factors.append(PrimeFactor(n, 1))
                self.total_factor_count += 1
                self.distinct_factor_count += 1
        return self

    # -- accessors (reference: math_utils.rs:162-191) --
    def is_prime(self) -> bool:
        return self.total_factor_count == 1

    def get_product(self) -> int:
        return self.n

    def get_power_of_two(self) -> int:
        return self.power_two

    def get_power_of_three(self) -> int:
        return self.power_three

    def get_other_factors(self) -> List[PrimeFactor]:
        return self.other_factors

    def has_factors_leq(self, factor: int) -> bool:
        """reference: math_utils.rs:240-247."""
        if self.power_two > 0 or self.power_three > 0:
            return True
        return bool(self.other_factors) and self.other_factors[0].value <= factor

    def has_factors_gt(self, factor: int) -> bool:
        """reference: math_utils.rs:250-257."""
        if factor < 2 and self.power_two > 0:
            return True
        if factor < 3 and self.power_three > 0:
            return True
        return bool(self.other_factors) and self.other_factors[-1].value > factor

    def product_above(self, min_factor: int) -> int:
        """Product of all factors greater than min_factor (math_utils.rs:260-266)."""
        product = 1
        for f in self.other_factors:
            if f.value > min_factor:
                product *= f.value**f.count
        return product

    def partition_factors(self) -> Tuple["PrimeFactors", "PrimeFactors"]:
        """Split into two near-equal halves (reference: math_utils.rs:269-368).

        Perfect square -> identical halves; single distinct factor -> split
        its exponent; otherwise greedy distribution of prime-power groups.
        """
        assert not self.is_prime()
        if (
            self.power_two % 2 == 0
            and self.power_three % 2 == 0
            and all(f.count % 2 == 0 for f in self.other_factors)
        ):
            half = 1 << (self.power_two // 2)
            half *= 3 ** (self.power_three // 2)
            for f in self.other_factors:
                half *= f.value ** (f.count // 2)
            return PrimeFactors.compute(half), PrimeFactors.compute(half)
        if self.distinct_factor_count == 1:
            if self.other_factors:
                f = self.other_factors[0]
                half_count = f.count // 2
                left = PrimeFactors.compute(f.value ** (f.count - half_count))
                right = PrimeFactors.compute(f.value**half_count)
                return left, right
            if self.power_two > 0:
                half = self.power_two // 2
                return (
                    PrimeFactors.compute(1 << (self.power_two - half)),
                    PrimeFactors.compute(1 << half),
                )
            half = self.power_three // 2
            return (
                PrimeFactors.compute(3 ** (self.power_three - half)),
                PrimeFactors.compute(3**half),
            )
        left_product = 1
        right_product = 1
        for f in self.other_factors:
            group = f.value**f.count
            if left_product <= right_product:
                left_product *= group
            else:
                right_product *= group
        if left_product <= right_product:
            left_product <<= self.power_two
        else:
            right_product <<= self.power_two
        if self.power_three > 0:
            if left_product <= right_product:
                left_product *= 3**self.power_three
            else:
                right_product *= 3**self.power_three
        return PrimeFactors.compute(left_product), PrimeFactors.compute(right_product)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"PrimeFactors(n={self.n}, 2^{self.power_two} * 3^{self.power_three} * "
            f"{[(f.value, f.count) for f in self.other_factors]})"
        )

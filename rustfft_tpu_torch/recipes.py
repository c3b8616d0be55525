"""Recipe AST: the planner's algorithm-selection output as pure data.

Copy of rustfft_tpu/recipes.py (reference `Recipe` enum, src/plan.rs:131-238).
A recipe is a frozen, hashable tree of dataclasses that the executor lowers
into one torch function; hashability keys the executor's build memo.  The
class and field names are the JAX package's, so `from_reference_recipe`
carries a recipe across packages and both plans can be built from one tree.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple


class Recipe:
    """Base class for all recipe nodes."""

    __slots__ = ()

    def __len__(self) -> int:
        return self.length  # type: ignore[attr-defined]


@dataclass(frozen=True)
class Dft(Recipe):
    """Dense DFT-matrix transform of any size, including 0 and 1."""

    length: int


@dataclass(frozen=True)
class Butterfly(Recipe):
    """Fixed-size base transform, sizes {2..9,11,12,13,16,17,19,23,24,27,29,31,32}
    (plan.rs:610-634); lowered as a DFT-matrix matmul."""

    length: int


@dataclass(frozen=True)
class Radix4(Recipe):
    """Power-of-two FFT: base butterfly + k layers of radix-4 cross FFTs
    (plan.rs:568-573).  Total length = base.length * 4**k."""

    k: int
    base: Recipe

    @property
    def length(self) -> int:
        return self.base.length * 4**self.k


@dataclass(frozen=True)
class RadixN(Recipe):
    """Radix chain over factors in {2,3,4,5,6,7} above a base (plan.rs:575-606)."""

    factors: Tuple[int, ...]
    base: Recipe

    @property
    def length(self) -> int:
        return self.base.length * math.prod(self.factors)


@dataclass(frozen=True)
class MixedRadix(Recipe):
    """Cooley-Tukey n = left * right (plan.rs:500-505)."""

    left: Recipe
    right: Recipe

    @property
    def length(self) -> int:
        return self.left.length * self.right.length


@dataclass(frozen=True)
class MixedRadixSmall(Recipe):
    """MixedRadix for two butterfly-sized factors (plan.rs:466-470,487-499)."""

    left: Recipe
    right: Recipe

    @property
    def length(self) -> int:
        return self.left.length * self.right.length


@dataclass(frozen=True)
class GoodThomas(Recipe):
    """Prime-Factor Algorithm for coprime left * right (plan.rs:378-384)."""

    left: Recipe
    right: Recipe

    @property
    def length(self) -> int:
        return self.left.length * self.right.length


@dataclass(frozen=True)
class GoodThomasSmall(Recipe):
    """Good-Thomas for butterfly sizes (plan.rs:460-464)."""

    left: Recipe
    right: Recipe

    @property
    def length(self) -> int:
        return self.left.length * self.right.length


@dataclass(frozen=True)
class Raders(Recipe):
    """Rader's algorithm: prime n via cyclic convolution of size n-1."""

    inner: Recipe

    @property
    def length(self) -> int:
        return self.inner.length + 1


@dataclass(frozen=True)
class Bluesteins(Recipe):
    """Bluestein's chirp-z algorithm: any n via an inner FFT of m >= 2n-1."""

    length: int
    inner: Recipe


_CLASSES = {
    cls.__name__: cls
    for cls in (Dft, Butterfly, Radix4, RadixN, MixedRadix, MixedRadixSmall,
                GoodThomas, GoodThomasSmall, Raders, Bluesteins)
}


def _convert(value):
    if isinstance(value, int):
        return int(value)
    if isinstance(value, tuple) and all(isinstance(v, int) for v in value):
        return tuple(int(v) for v in value)
    return from_reference_recipe(value)


def from_reference_recipe(recipe_like) -> Recipe:
    """This package's recipe for a JAX-package recipe.

    `recipe_like` is a recipe dataclass of either package (read through its
    dataclass fields), or the nested form ``(class name, {field: value})``
    with nested recipes in the same form.
    """
    if isinstance(recipe_like, tuple) and len(recipe_like) == 2 and isinstance(
        recipe_like[0], str
    ):
        name, fields = recipe_like
        fields = dict(fields)
    elif dataclasses.is_dataclass(recipe_like) and not isinstance(recipe_like, type):
        name = type(recipe_like).__name__
        fields = {
            f.name: getattr(recipe_like, f.name)
            for f in dataclasses.fields(recipe_like)
        }
    else:
        raise TypeError(f"not a recipe: {recipe_like!r}")
    cls = _CLASSES.get(name)
    if cls is None:
        raise ValueError(f"unknown recipe class {name!r}")
    return cls(**{k: _convert(v) for k, v in fields.items()})

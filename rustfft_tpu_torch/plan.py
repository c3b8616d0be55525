"""The plan object: the torch counterpart of the `Fft<T>` trait.

Port of rustfft_tpu/plan.py (reference: src/lib.rs:184-278).  The four
process methods and three scratch-size queries are kept for API parity; the
caching allocator owns every buffer, so each scratch query returns 0 and
every process variant runs the same computation and returns its result.
Batching keeps the reference contract: any buffer whose last-axis length is a
multiple of `len` is processed as independent chunks.

A torch tensor stays on its own device, output included.  Any other buffer
goes through numpy: it is copied to the plan's device (the card unless the
caller passes device="cpu"), transformed, and returned as a numpy array.
With no GPU, a numpy buffer on a CUDA device raises; it is never computed
on the CPU instead.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import executor, recipes
from .common import (FftBufferError, FftDirection, canonical_complex_dtype,
                     torch_dtype, validate_buffer_len)
from .ops import calg


class FftPlan:
    """A planned FFT of one (length, direction, dtype), reusable and
    immutable after construction."""

    def __init__(self, recipe: recipes.Recipe, direction: FftDirection, dtype,
                 device="cuda", pinned: bool = False):
        self._recipe = recipe
        self._direction = direction
        self._dtype = canonical_complex_dtype(dtype)
        self._torch_dtype = torch_dtype(self._dtype)
        self._device = torch.device(device)
        # pinned=True (the hand-built algorithm.py constructors) runs the
        # literal recipe: no whole-transform kernel and no convolution core
        self._pinned = pinned
        self._fn = executor.build(recipe, direction, self._dtype, pinned=pinned)

    # -- Length / Direction traits (lib.rs:140-143, 174-177) --
    @property
    def recipe(self) -> recipes.Recipe:
        return self._recipe

    def __len__(self) -> int:
        return self._recipe.length

    @property
    def length(self) -> int:
        return self._recipe.length

    def fft_direction(self) -> FftDirection:
        return self._direction

    @property
    def direction(self) -> FftDirection:
        return self._direction

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def pinned(self) -> bool:
        """True where the plan runs its literal recipe (algorithm.py)."""
        return self._pinned

    # -- process family (lib.rs:184-278) --
    def process(self, buffer: Any):
        """Compute FFTs over `buffer`, returning a new array or tensor.

        `buffer`'s last dimension must be a multiple of `len(self)`; each
        length-`len` chunk is transformed independently.  Output is ascending
        frequency order, DC first, unnormalized (lib.rs:81-89).
        """
        is_tensor = isinstance(buffer, torch.Tensor)
        if is_tensor:
            x = buffer.to(self._torch_dtype)
        else:
            x = self._to_device(torch.from_numpy(np.array(buffer, dtype=self._dtype)))
        n = self._recipe.length
        if x.dim() == 0:
            raise FftBufferError("FFT input must have at least one dimension")
        chunks = validate_buffer_len(x.shape[-1], n)
        shape = x.shape
        if n <= 1 or shape[-1] == 0:
            out = x.clone()
        else:
            out = self._fn(x.reshape(shape[:-1] + (chunks, n))).reshape(shape)
        return out if is_tensor else out.cpu().numpy()

    def process_pair(self, re, im):
        """(re, im) real arrays or tensors of shape (..., len) -> (re, im)
        tensors: the pair form of the JAX package's device-level entry."""
        on_device = isinstance(re, torch.Tensor)
        x = calg.from_pair(re, im, self._torch_dtype)
        if not on_device:
            x = self._to_device(x)
        return calg.to_pair(self.process(x))

    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        """A host tensor on the plan's device; raises when that is a CUDA
        device and there is no GPU."""
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"FftPlan: the plan's device is {self._device} and no CUDA GPU is available; "
                "pass device='cpu' to the planner to compute on the CPU")
        return x.to(self._device)

    @property
    def raw_fn(self):
        """The plan's function on complex tensors (..., len) -> (..., len)."""
        return self._fn

    def __call__(self, buffer: Any):
        return self.process(buffer)

    def process_with_scratch(self, buffer: Any, scratch: Any = None):
        """API parity with lib.rs:214-226; scratch is ignored."""
        return self.process(buffer)

    def process_outofplace_with_scratch(self, input: Any, output: Any = None, scratch: Any = None):
        """API parity with lib.rs:231-242; returns the output instead of writing it."""
        return self.process(input)

    def process_immutable_with_scratch(self, input: Any, output: Any = None, scratch: Any = None):
        """API parity with lib.rs:250-259 (input untouched, always true here)."""
        return self.process(input)

    # -- scratch queries (lib.rs:262-277): the caching allocator owns buffers --
    def get_inplace_scratch_len(self) -> int:
        return 0

    def get_outofplace_scratch_len(self) -> int:
        return 0

    def get_immutable_scratch_len(self) -> int:
        return 0

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"FftPlan(len={self._recipe.length}, direction={self._direction.name}, "
            f"dtype={self._dtype}, device={self._device}, "
            f"recipe={type(self._recipe).__name__}{', pinned' if self._pinned else ''})"
        )

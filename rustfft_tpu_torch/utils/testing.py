"""Verification harness: port of rustfft_tpu/utils/testing.py (reference
src/test_utils.rs).

* `random_signal` - deterministic seeded signals (test_utils.rs:19-34).
* `compare_vectors` - mean element error < 0.1 (test_utils.rs:36-43,
  tests/accuracy.rs:30-37).
* `check_fft_algorithm` - the per-algorithm conformance check
  (test_utils.rs:70-209): asserts reported length/direction, runs every
  process entry point against the oracle, and exercises the batch-chunking
  loop with a batch of 3.  The reference's dirty-scratch robustness checks
  have no analogue (the caching allocator owns scratch), so the closest
  translation, that the input buffer is never mutated, is asserted instead.

Signals are numpy arrays: a plan computes them on its own device (the card
unless it was built with device="cpu") and returns numpy arrays.
"""
from __future__ import annotations

import numpy as np

from ..common import FftDirection
from ..twiddles import host_dft

#: Deterministic RNG seed (tests/accuracy.rs:23-25 uses a fixed 32-byte seed).
RNG_SEED = 19101143

COMPARE_TOLERANCE = 0.1


def random_signal(length: int, dtype=np.complex64, seed: int = RNG_SEED) -> np.ndarray:
    """Seeded complex normal signal (test_utils.rs:19-34)."""
    rng = np.random.default_rng(seed)
    real = rng.standard_normal(length)
    imag = rng.standard_normal(length)
    return (real + 1j * imag).astype(dtype)


def oracle_dft(x: np.ndarray, direction: FftDirection) -> np.ndarray:
    """Unnormalized f64 DFT oracle over the last axis.

    Stands in for the reference's naive Dft oracle (algorithm/dft.rs:22-81);
    host f64 FFT is at least as accurate.
    """
    return host_dft(x, direction)


def mean_element_error(actual, expected) -> float:
    actual = np.asarray(actual, dtype=np.complex128)
    expected = np.asarray(expected, dtype=np.complex128)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    if actual.size == 0:
        return 0.0
    return float(np.mean(np.abs(actual - expected)))


def compare_vectors(actual, expected, tol: float = COMPARE_TOLERANCE) -> bool:
    """Mean |a - b| over elements < tol (test_utils.rs:36-43)."""
    return mean_element_error(actual, expected) < tol


def check_fft_algorithm(plan, length: int, direction: FftDirection,
                        dtype=np.complex64) -> float:
    """Port of check_fft_algorithm (test_utils.rs:70-209).  Returns the
    relative mean error of process() against the oracle (0 for an empty
    or all-zero oracle), for callers that hold a plan to a tighter bar."""
    assert len(plan) == length, f"plan reports len {len(plan)}, expected {length}"
    assert plan.fft_direction() is direction, "plan reports wrong direction"

    n_chunks = 3
    signal = random_signal(length * n_chunks, dtype=dtype, seed=RNG_SEED + length)
    expected = oracle_dft(signal.reshape(n_chunks, length), direction).reshape(-1)

    # process() on a flat buffer exercises the chunking loop (lib.rs:200-209)
    out = np.asarray(plan.process(signal))
    err = mean_element_error(out, expected)
    assert err < COMPARE_TOLERANCE, (
        f"process() failed, len={length}, direction={direction}, mean err={err}"
    )

    # input must be untouched (the functional analogue of
    # process_immutable_with_scratch, lib.rs:250-259)
    np.testing.assert_array_equal(
        signal, random_signal(length * n_chunks, dtype=dtype, seed=RNG_SEED + length)
    )

    # the other process entry points must agree exactly
    for method in (
        plan.process_with_scratch,
        plan.process_outofplace_with_scratch,
        plan.process_immutable_with_scratch,
    ):
        alt = np.asarray(method(signal))
        np.testing.assert_array_equal(out, alt)

    # batched nd input: (3, length) must equal the flat chunked result
    out2 = np.asarray(plan.process(signal.reshape(n_chunks, length)))
    np.testing.assert_allclose(out2.reshape(-1), out, rtol=0, atol=0)

    scale = float(np.mean(np.abs(expected))) if expected.size else 0.0
    return err / scale if scale > 0 else 0.0

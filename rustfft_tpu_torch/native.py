"""ctypes bindings for the checked-in native plancore library.

The planner's setup path (number theory, scalar-parity recipe design and the
f64 host tables) has a C++ implementation in native/plancore.cc, shared with
the JAX package.  This module only loads the library that is checked in as
native/libplancore.so; it never builds it.  If the library is absent or fails
to load, every function returns None and callers use the pure-Python
implementations (math_utils.py, planner.py, twiddles.py), which the parity
tests pin to identical outputs.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native",
    "libplancore.so",
)

_lib = None
_tried = False
_load_lock = threading.Lock()


def _load():
    with _load_lock:
        return _load_locked()


def _load_locked():
    """_load's body: under the lock, so that no thread sees _tried set
    before _lib is."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.pc_is_prime.restype = ctypes.c_int
    lib.pc_is_prime.argtypes = [ctypes.c_uint64]
    lib.pc_primitive_root.restype = ctypes.c_uint64
    lib.pc_primitive_root.argtypes = [ctypes.c_uint64]
    lib.pc_factorize.restype = ctypes.c_int64
    lib.pc_factorize.argtypes = [
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
    ]
    lib.pc_design_recipe.restype = ctypes.c_int64
    lib.pc_design_recipe.argtypes = [
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.pc_twiddles.restype = None
    lib.pc_twiddles.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
    ]
    for name, args in (
        ("pc_dft_matrix", [ctypes.c_uint64, ctypes.c_int]),
        ("pc_twiddle_table", [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int]),
        ("pc_bluestein_chirp", [ctypes.c_uint64, ctypes.c_int]),
    ):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = args + [ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _table(fn_name: str, shape, *int_args) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    out = np.empty(shape + (2,), dtype=np.float64)
    getattr(lib, fn_name)(*int_args, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out.view(np.complex128).reshape(shape)


def dft_matrix(n: int, conjugate: bool) -> Optional[np.ndarray]:
    """Dense n x n DFT matrix (complex128) via pc_dft_matrix."""
    if n == 0 or n >= 2**31:
        return None
    return _table("pc_dft_matrix", (n, n), ctypes.c_uint64(n), int(conjugate))


def twiddle_table(p: int, q: int, conjugate: bool) -> Optional[np.ndarray]:
    """Cooley-Tukey twiddle table (p, q) via pc_twiddle_table."""
    if p * q >= 2**31 or p == 0 or q == 0:
        return None
    return _table(
        "pc_twiddle_table", (p, q),
        ctypes.c_uint64(p), ctypes.c_uint64(q), int(conjugate),
    )


def bluestein_chirp(n: int, conjugate: bool) -> Optional[np.ndarray]:
    """Bluestein chirp of length n via pc_bluestein_chirp (exact k^2 mod 2n)."""
    if n == 0 or n >= 2**62:
        return None
    return _table("pc_bluestein_chirp", (n,), ctypes.c_uint64(n), int(conjugate))


def twiddle_values(indices: np.ndarray, fft_len: int, conjugate: bool) -> Optional[np.ndarray]:
    """w_{fft_len}^index for every index (complex128) via pc_twiddles."""
    lib = _load()
    if lib is None:
        return None
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    out = np.empty(idx.size * 2, dtype=np.float64)
    lib.pc_twiddles(
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        idx.size,
        float(fft_len),
        1 if conjugate else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out.view(np.complex128).reshape(idx.shape)


def is_prime(n: int) -> Optional[bool]:
    lib = _load()
    if lib is None or n >= 2**63:
        return None
    return bool(lib.pc_is_prime(n))


def primitive_root(prime: int) -> Optional[int]:
    lib = _load()
    if lib is None or prime >= 2**63:
        return None
    r = lib.pc_primitive_root(prime)
    return int(r) if r else None


def factorize(n: int) -> Optional[List[Tuple[int, int]]]:
    lib = _load()
    if lib is None or n >= 2**63:
        return None
    cap = 128
    values = (ctypes.c_uint64 * cap)()
    counts = (ctypes.c_uint64 * cap)()
    k = lib.pc_factorize(n, values, counts, cap)
    return [(int(values[i]), int(counts[i])) for i in range(min(k, cap))]


def design_recipe_tokens(n: int) -> Optional[List[int]]:
    """Postfix token stream for the scalar-parity recipe of n (see plancore.cc)."""
    lib = _load()
    if lib is None or n >= 2**63:
        return None
    cap = 4096
    out = (ctypes.c_int64 * cap)()
    k = lib.pc_design_recipe(n, out, cap)
    if k < 0:
        return None
    return [int(out[i]) for i in range(k)]


def parse_recipe_tokens(tokens: List[int]):
    """Decode the plancore postfix token stream into a Recipe tree."""
    from . import recipes

    pairs = {
        5: recipes.MixedRadix,
        6: recipes.MixedRadixSmall,
        7: recipes.GoodThomas,
        8: recipes.GoodThomasSmall,
    }
    stack = []
    i = 0
    while i < len(tokens):
        op = tokens[i]
        i += 1
        if op == 1:
            stack.append(recipes.Dft(tokens[i])); i += 1
        elif op == 2:
            stack.append(recipes.Butterfly(tokens[i])); i += 1
        elif op == 3:
            base = stack.pop()
            stack.append(recipes.Radix4(tokens[i], base)); i += 1
        elif op == 4:
            m = tokens[i]; i += 1
            factors = tuple(tokens[i : i + m]); i += m
            base = stack.pop()
            stack.append(recipes.RadixN(factors, base))
        elif op in pairs:
            right = stack.pop()
            left = stack.pop()
            stack.append(pairs[op](left, right))
        elif op == 9:
            stack.append(recipes.Raders(stack.pop()))
        elif op == 10:
            inner = stack.pop()
            stack.append(recipes.Bluesteins(tokens[i], inner)); i += 1
        else:
            raise ValueError(f"bad plancore opcode {op}")
    if len(stack) != 1:
        raise ValueError(f"bad plancore token stream (stack={len(stack)})")
    return stack[0]


def design_recipe(n: int):
    """Native scalar-parity recipe design, or None if unavailable."""
    tokens = design_recipe_tokens(n)
    if tokens is None:
        return None
    return parse_recipe_tokens(tokens)

"""Numeric and pretty-printing helpers.

Capability parity with the reference's ``qbot/helpers.py`` (see
qbot/helpers.py:9-138): integer log2, roots of unity, shape
guards, best-rational approximation and the algebraic float/complex/ket
pretty-printer.  Fresh implementation; the reference's ``stateVecStr`` bug
(ket labels formatted with ``size-1`` bits instead of ``log2(size)``,
helpers.py:131-138) is fixed here.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = [
    "int_log2",
    "nth_roots_of_unity",
    "require_square",
    "require_vector",
    "best_rational",
    "float_to_algebra",
    "complex_to_algebra",
    "state_vec_str",
]


def int_log2(x: int) -> int:
    """Integer log2; 0-size arrays count as 0 qubits."""
    if x == 0:
        return 0
    return int(x).bit_length() - 1


def nth_roots_of_unity(n: int) -> np.ndarray:
    return np.exp(2j * np.pi * np.arange(n) / n)


def require_square(arr) -> int:
    """Return the side length of a square 2-D array (0 for empty arrays)."""
    if arr.size == 0:
        return 0
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
        raise ValueError(f"expected a square matrix, got shape {arr.shape}")
    return arr.shape[0]


def require_vector(arr) -> int:
    if arr.ndim != 1:
        raise ValueError(f"expected a 1-D vector, got shape {arr.shape}")
    return arr.shape[0]


def best_rational(x: float, max_denom: int) -> tuple[int, int]:
    """Best rational approximation of ``x`` with denominator <= max_denom.

    Stern-Brocot / mediant search (same capability as the reference's
    ``farey``/``bestRationalApprox``, helpers.py:47-74).
    """
    whole = int(math.floor(x))
    frac = x - whole
    lo_n, lo_d = 0, 1
    hi_n, hi_d = 1, 1
    best_n, best_d = 0, 1
    while True:
        med_n, med_d = lo_n + hi_n, lo_d + hi_d
        if med_d > max_denom:
            break
        if frac == med_n / med_d:
            best_n, best_d = med_n, med_d
            break
        if frac > med_n / med_d:
            lo_n, lo_d = med_n, med_d
        else:
            hi_n, hi_d = med_n, med_d
        # track closest endpoint so far
        if abs(frac - med_n / med_d) < abs(frac - best_n / best_d):
            best_n, best_d = med_n, med_d
    for cn, cd in ((lo_n, lo_d), (hi_n, hi_d)):
        if cd <= max_denom and abs(frac - cn / cd) < abs(frac - best_n / best_d):
            best_n, best_d = cn, cd
    return best_n + whole * best_d, best_d


_MAX_DENOM = 50
_TOL = 1e-6
_SYMBOL_VALS = [
    (math.sqrt(2), "√2"),
    (math.sqrt(3), "√3"),
    (math.sqrt(5), "√5"),
    (math.pi, "π"),
    (math.e, "e"),
    (math.sqrt(math.pi), "√π"),
    (math.sqrt(2 * math.pi), "√2√π"),
]


def _close(a: float, b: float) -> bool:
    return abs(a - b) < _TOL


def float_to_algebra(f: float, numerator_suffix: str = "") -> str:
    """Render a float as an exact-looking algebraic string when possible.

    Recognises rationals and rational multiples of √2, √3, √5, π, e, √π, √2π
    in either the numerator or the denominator, e.g. ``0.7071...`` → ``1/√2``.
    """
    n, d = best_rational(f, _MAX_DENOM)
    if _close(f, n / d):
        out = f"{n}{numerator_suffix}"
        return out if d == 1 else f"{out}/{d}"

    for val, sym in _SYMBOL_VALS:
        coeff = f / val
        n, d = best_rational(coeff, _MAX_DENOM)
        if _close(coeff, n / d):
            out = f"{n if n != 1 else ''}{sym}{numerator_suffix}"
            return out if d == 1 else f"{out}/{d}"

    for val, sym in _SYMBOL_VALS:
        coeff = f * val
        n, d = best_rational(coeff, _MAX_DENOM)
        if _close(coeff, n / d):
            denom = f"{d}{sym}" if d != 1 else sym
            return f"{n}{numerator_suffix}/{denom}"

    return f"{round(f, 6)}{numerator_suffix}"


def complex_to_algebra(c: complex) -> str:
    re = float_to_algebra(c.real)
    im = float_to_algebra(c.imag, "j")
    if im == "0j":
        return re
    if re == "0":
        return im
    return f"({re} + {im})"


def state_vec_str(state: np.ndarray) -> str:
    """Human-readable ket-sum rendering of a state vector."""
    size = require_vector(state)
    bits = max(int_log2(size), 1)
    terms = []
    for i in range(size):
        terms.append(f"{complex_to_algebra(complex(state[i]))} |{format(i, f'0{bits}b')}〉")
    return " + ".join(terms)

"""Numeric backend of the DSL's dense host interpreter.

Copy of :mod:`qbot_tpu.backend` with numpy as the only engine: the dense
interpreter's register math runs in complex128 numpy (the bit-exact
conformance surface).  The JAX package's ``jax`` backend has no place in
the port; asking for it raises.  Every engine function in
:mod:`qbot_tpu_torch.ops` is written against the generic ``xp`` interface.
"""
from __future__ import annotations

import numpy as np

_DTYPE: str | None = None      # None = numpy's complex128; "c64" | "c128"


def set_backend(name: str) -> None:
    """Accept ``numpy``, the only engine; raise for any other."""
    if name == "jax":
        raise ValueError("the jax backend is not part of qbot_tpu_torch, "
                         "which imports no jax: use numpy")
    if name != "numpy":
        raise ValueError(f"unknown backend {name!r} (expected numpy)")


def xp():
    """The array namespace (numpy)."""
    return np


def is_array(v) -> bool:
    """True for an engine array (a numpy ndarray)."""
    return isinstance(v, np.ndarray)


def set_dtype(name: str | None) -> None:
    """Select the register's complex precision (CLI ``--dtype``).

    ``None`` keeps the default, complex128.
    """
    global _DTYPE
    if name not in (None, "c64", "c128"):
        raise ValueError(f"unknown dtype {name!r} (expected c64|c128)")
    _DTYPE = name


def complex_dtype():
    """The active complex dtype for register states."""
    return np.complex64 if _DTYPE == "c64" else np.complex128


def dtype_override():
    """The explicitly requested complex dtype, or None when defaulted."""
    return None if _DTYPE is None else complex_dtype()

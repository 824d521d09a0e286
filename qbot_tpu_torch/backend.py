"""Numeric backend of the DSL's dense host interpreter.

Copy of :mod:`qbot_tpu.backend` with numpy as the only engine: the dense
interpreter's register math runs in complex128 numpy (the bit-exact
conformance surface).  The JAX package's ``jax`` backend has no place in
the port; asking for it raises.  Every engine function in
:mod:`qbot_tpu_torch.ops` is written against the generic ``xp`` interface.
"""
from __future__ import annotations

import numpy as np


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

"""Helpers of the port's parity tests (``tests/test_torch_*.py``).

The port keeps its own copy of ``qbot_tpu``'s host layer, so a circuit or a
plan of one package is not an instance of the other's classes.  A parity
test builds the same circuit in both packages from the same seed
(:func:`both`) and compares plans field by field, by class name
(:func:`assert_same`).
"""
import dataclasses

import numpy as np

from qbot_tpu.tpu import circuit as jax_circuit
from qbot_tpu_torch.tpu import circuit as torch_circuit


def both(make):
    """(the port's circuit, ``qbot_tpu``'s circuit) of ``make(module)``,
    ``module`` being each package's ``tpu.circuit``."""
    return make(torch_circuit), make(jax_circuit)


def grover_body(m, n, marked):
    c = m.Circuit(n)
    c.phase_flip(marked)
    for q in range(n):
        c.h(q)
    c.phase_flip(0)
    for q in range(n):
        c.h(q)
    return c


def brickwork(m, n, layers, seed=0):
    """``bench.py``'s random brickwork: Haar 1-qubit gates, then CX on
    alternating neighbour pairs, per layer."""
    rng = np.random.default_rng(seed)
    c = m.Circuit(n)
    X = np.array([[0, 1], [1, 0]], dtype=complex)
    for layer in range(layers):
        for q in range(n):
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            qm, r = np.linalg.qr(z)
            c.gate(qm * np.conj(r.diagonal() / np.abs(r.diagonal())), [q])
        for q in range(layer % 2, n - 1, 2):
            c.gate(X, [q + 1], controls=[q])
    return c


# the port's name of each engine -> the reference's (Plan.engine)
ENGINES = {"kernel": "pallas", "dot": "dot"}


def assert_same(a, b, where="plan"):
    """``a`` (the port's) equals ``b`` (``qbot_tpu``'s): the same class
    name and, for a dataclass, every field of ``a``'s class; arrays
    bit-identical; a parameterised gate's maker made by the same builder
    (the same qualified name); a plan's engine by :data:`ENGINES`."""
    assert type(a).__name__ == type(b).__name__, \
        f"{where}: {type(a).__name__} != {type(b).__name__}"
    if where.endswith(".engine"):
        assert ENGINES[a] == b, f"{where}: {a!r} is not {b!r}"
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif callable(a) and callable(b):
        assert a.__qualname__ == b.__qualname__, \
            f"{where}: {a.__qualname__} != {b.__qualname__}"
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), f"{where}: {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"

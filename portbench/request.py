"""What the traffic hands to both sides: one request, as plain data.

A circuit is a list of ops, each ``("gate", targets, matrix, controls)``
(a complex128 unitary on ``targets``, applied where every control qubit is
1) or ``("flip", index)`` (the sign of one basis state negated).  Qubit 0
is the most significant bit of a basis index.  A program with mid-circuit
measurement is its DSL text for the program under test and, for the
reference, the same program as events: ``("gates", ops)``,
``("meas", name, targets)`` and ``("disc", targets)``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)
X = np.array([[0, 1], [1, 0]], dtype=np.complex128)


@dataclass
class Request:
    """One request of a cell; every run of the window sends it again."""
    kind: str                     # "circuit" or "program"
    n: int
    seed: int
    init_ops: list = field(default_factory=list)
    body_ops: list = field(default_factory=list)
    repeats: int = 1
    text: str = ""
    events: list = field(default_factory=list)
    sample: int = 0               # SMC particles; 0: the exact fan-out
    max_particles: int = 256
    prune_tol: float = 1e-6
    # the work one run completes, by unit: {"gates": ...}, {"samples": ...}
    per_run: dict = field(default_factory=dict)

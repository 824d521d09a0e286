"""Random brickwork on a mixed initial state: every qubit starts thermal,
diag(1 − p_q, p_q), with a residual excited population p_q drawn uniform in
[0.01, 0.10] from ``--seed`` (imperfect reset), and the body of
``families/brickwork.py`` (``brickwork_ops``, its Haar gates from the same
seed) is applied ``repeats`` times.  The product of the n factors is full
rank, so the state is a density matrix and not a pure state in disguise.

Parameters: ``layers`` (of the body), ``repeats`` (bodies a run)."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from portbench.families.brickwork import brickwork_ops
from portbench.request import Request

P_LOW, P_HIGH = 0.01, 0.10     # residual excited population of a qubit


@dataclass
class ThermalRequest(Request):
    """A circuit request whose initial state is the product of ``rhos``,
    one 2 × 2 complex128 matrix a qubit (qubit 0 first)."""
    rhos: list = field(default_factory=list)


def thermal_factors(n: int, seed: int) -> list:
    p = np.random.default_rng([seed, 2]).uniform(P_LOW, P_HIGH, size=n)
    return [np.diag([1.0 - x, x]).astype(np.complex128) for x in p]


def build(config: dict, traffic: dict, seed: int) -> ThermalRequest:
    n = config["qubits"]
    body = brickwork_ops(n, traffic["layers"], seed)
    repeats = traffic["repeats"]
    return ThermalRequest("circuit", n, seed, body_ops=body, repeats=repeats,
                          per_run={"gates": len(body) * repeats},
                          rhos=thermal_factors(n, seed))

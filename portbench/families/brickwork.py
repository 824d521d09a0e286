"""Random brickwork: a body of Haar 1-qubit gates on every qubit, then CX
on alternating neighbour pairs, per layer, applied ``repeats`` times to
|0…0⟩.  The layer is a frozen copy of ``chip_smoke.py:1116-1129``
(``bench.py``'s random circuit), its Haar gates drawn from ``--seed``.

Parameters: ``layers`` (of the body), ``repeats`` (bodies a run)."""
from __future__ import annotations

import numpy as np

from portbench.request import X, Request


def brickwork_ops(n: int, layers: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    ops = []
    for layer in range(layers):
        for q in range(n):
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            qm, r = np.linalg.qr(z)
            u = qm * np.conj(r.diagonal() / np.abs(r.diagonal()))
            ops.append(("gate", (q,), u.astype(np.complex128), ()))
        for q in range(layer % 2, n - 1, 2):
            ops.append(("gate", (q + 1,), X, (q,)))
    return ops


def build(config: dict, traffic: dict, seed: int) -> Request:
    n = config["qubits"]
    body = brickwork_ops(n, traffic["layers"], seed)
    repeats = traffic["repeats"]
    return Request("circuit", n, seed, body_ops=body, repeats=repeats,
                   per_run={"gates": len(body) * repeats})

"""Grover search: Hadamards on every qubit, then ``repeats`` iterations of
the oracle (a sign flip of the marked basis state) and the diffusion
(Hadamards, a flip of |0…0⟩, Hadamards).  A frozen copy of
``chip_smoke.py:1087-1101`` (``bench.py``'s Grover workload), with the
marked index drawn from ``--seed`` in place of ``12345 % 2^n``.

Parameters: ``repeats`` (iterations a run)."""
from __future__ import annotations

import numpy as np

from portbench.request import H, Request


def grover_ops(n: int, marked: int) -> tuple[list, list]:
    """(init ops, iteration ops)."""
    init = [("gate", (q,), H, ()) for q in range(n)]
    body = [("flip", marked)]
    body += [("gate", (q,), H, ()) for q in range(n)]
    body += [("flip", 0)]
    body += [("gate", (q,), H, ()) for q in range(n)]
    return init, body


def build(config: dict, traffic: dict, seed: int) -> Request:
    n = config["qubits"]
    marked = int(np.random.default_rng(seed).integers(0, 2 ** n))
    init, body = grover_ops(n, marked)
    repeats = traffic["repeats"]
    return Request("circuit", n, seed, init_ops=init, body_ops=body,
                   repeats=repeats,
                   per_run={"gates": len(init) + len(body) * repeats})

"""``bench.py``'s mid-circuit measurement program (``bench.py:421-436``),
a frozen copy of ``chip_smoke.py:1755-1769``: layers of Hadamards and CX
on every third qubit around three measurements and a discard (4 collapse
events), as DSL text for the program and as events for the reference.

Parameters: ``sample`` (SMC particles a run; 0 runs the exact fan-out),
``max_particles`` and ``prune_tol`` (the exact fan-out's cap and the lost
mass it tolerates), ``trajectories_per_run`` (the exact fan-out's final
branches of nonzero probability, which the reference counts again) and
``rotations``: when true, every Hadamard becomes ``yRotGate(θ)`` with θ
drawn from ``--seed`` uniformly in [π/4, 3π/4], so each outcome's
probability lies between 0.15 and 0.85 and differs from branch to branch
(with Hadamards every amplitude has one magnitude, which a renormalised
particle cannot show wrong).  The gates and their places are the same for
every seed.  The seed of a sampled run's draws comes from ``--seed`` too.
"""
from __future__ import annotations

import math

import numpy as np

from portbench.request import H, X, Request


def ry(theta: float) -> np.ndarray:
    """exp(-i θ Y / 2), as the program's ``yRotGate`` builds it."""
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=np.complex128)


def smc_program(n: int, angles=None) -> tuple[str, list]:
    """(DSL text, reference events) of the program on ``n`` qubits; with
    ``angles`` (an iterator of floats) each Hadamard is a Y rotation by the
    next angle."""
    def one(q):
        if angles is None:
            return f"gate hadamardGate ; {q}", ("gate", (q,), H, ())
        theta = float(next(angles))
        return (f"gate yRotGate({theta!r}) ; {q}",
                ("gate", (q,), ry(theta), ()))

    def layers():
        ones = [one(q) for q in range(0, n, 3)]
        text = ([t for t, _ in ones]
                + [f"gate pauliXGate ; {q + 1} ; [{q}]"
                   for q in range(0, n - 1, 3)])
        ops = ([o for _, o in ones]
               + [("gate", (q + 1,), X, (q,)) for q in range(0, n - 1, 3)])
        return text, ops

    (t1, o1), (t2, o2) = layers(), layers()
    t_mid, o_mid = one(n // 2)
    t3, o3 = layers()
    lines = [f"qset tensorExp(computation.kets[0], {n})", *t1,
             "meas a ; computation ; [0]", *t2, t_mid,
             f"meas b ; computation ; [{n // 2}]", *t3,
             f"disc [{n - 1}]", "meas c ; computation ; [1, 2]"]
    events = [("gates", o1), ("meas", "a", (0,)),
              ("gates", o2 + [o_mid]),
              ("meas", "b", (n // 2,)), ("gates", o3),
              ("disc", (n - 1,)), ("meas", "c", (1, 2))]
    return "\n".join(lines), events


def build(config: dict, traffic: dict, seed: int) -> Request:
    n = config["qubits"]
    angles = None
    if traffic.get("rotations"):
        rng = np.random.default_rng([seed, 3])
        angles = iter(rng.uniform(math.pi / 4, 3 * math.pi / 4, size=4 * n))
    text, events = smc_program(n, angles)
    sample = traffic["sample"]
    per_run = sample if sample else traffic["trajectories_per_run"]
    return Request("program", n, seed, text=text, events=events,
                   sample=sample,
                   max_particles=traffic.get("max_particles", 256),
                   prune_tol=traffic.get("prune_tol", 1e-6),
                   per_run={"samples": per_run})

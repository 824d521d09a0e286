"""The ranks of ``tests/test_torch_sharded.py``.

Each rank of a gloo mesh on the CPU runs every case on its shard; rank 0
writes the gathered results to one npz file a case.  The ranks start with
the spawn method and import this module, which imports neither ``jax`` nor
``qbot_tpu``: the case builders take a package's ``tpu.circuit`` module,
so the test builds the same circuits in ``qbot_tpu`` from the same seeds.
"""
import time
from pathlib import Path

import numpy as np
import torch

from qbot_tpu_torch.frontend.lowering import (
    _full_circuit,
    lower_program,
    run_lowered_sharded,
)
from qbot_tpu_torch.tpu import circuit as torch_circuit
from qbot_tpu_torch.tpu import sharded

ROOT = Path(__file__).resolve().parent.parent

# the marginals read: every qubit, and targets on sharded and local axes
PROB_TARGETS = {"all": None, "ends": (0, -1), "mixed": (1, 2, -2)}
# the statevector cases whose marginals are read
PROB_CASES = ("random", "spanning")
# the qubits discarded from the density case "random": one on a row axis
# that starts sharded, one local, two
DISCARDS = {"first": (0,), "last": (-1,), "two": (1, 2)}


def _haar(rng, d: int = 2) -> np.ndarray:
    z = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    q, r = np.linalg.qr(z)
    return q * np.conj(r.diagonal() / np.abs(r.diagonal()))


def _h_layer(c, n):
    for q in range(n):
        c.h(q)
    return c


def brickwork(m, n, layers, seed):
    """Haar 1-qubit gates, then CX on alternating neighbour pairs, a
    layer."""
    rng = np.random.default_rng(seed)
    c = m.Circuit(n)
    for layer in range(layers):
        for q in range(n):
            c.gate(_haar(rng), [q])
        for q in range(layer % 2, n - 1, 2):
            c.cx(q, q + 1)
    return c


def _mcz(m, n):
    c = _h_layer(m.Circuit(n), n)
    c.gate(np.diag([1.0, -1.0]).astype(complex), [n - 1], list(range(n - 1)))
    return _h_layer(c, n)


def _phase_diag(m, n):
    c = _h_layer(m.Circuit(n), n)
    # a diagonal straddling the shard boundary, unsorted; S on qubits that
    # start sharded (the first alone: a phase with no local axis)
    c.diagonal(np.exp(1j * np.linspace(0.3, 2.1, 8)), [5, 1, 6])
    c.gate(np.diag([1, 1j]).astype(complex), [2])
    c.gate(np.diag([1, np.exp(0.4j)]).astype(complex), [0])
    return c


def _reflect(m, n, unitaries, index):
    c = m.Circuit(n)
    for q, u in enumerate(unitaries):
        c.gate(u, [q])
    c.phase_flip(index)
    for q, u in enumerate(unitaries):
        c.gate(u.conj().T, [q])
    return c


def _rotations(n):
    return [np.array([[np.cos(t / 2), -np.sin(t / 2)],
                      [np.sin(t / 2), np.cos(t / 2)]], complex)
            for t in 0.3 + 0.1 * np.arange(n)]


def _not_reflect(m, n):
    c = _h_layer(m.Circuit(n), n)
    c.phase_flip(5)
    for q in range(n):
        c.x(q)                      # X != H^-1: no reflection
    return c


def _param(m, n):
    c = m.Circuit(n)
    for q in range(n):
        c.pry(q, q)
    c.cx(0, n - 1)
    return c


def _spanning(m, n):
    c = _h_layer(m.Circuit(n), n)
    c.cx(0, n - 1)
    c.swap(1, n - 2)
    c.cz(n - 1, 0)
    c.gate(_haar(np.random.default_rng(5)), [n - 1], [0, 1])
    return c


def state_cases(m, k: int) -> dict:
    """{name: (circuit, params or None)} of the statevector cases on a
    2^k-way register (n >= 2k)."""
    rng = np.random.default_rng(40 + k)
    return {
        "h_layer": (_h_layer(m.Circuit(8), 8), None),
        "random": (m.random_circuit(9, 3, seed=12), None),
        "brickwork": (brickwork(m, 9, 4, seed=3), None),
        "grover": (m.grover_circuit(8, marked=37, iterations=6), None),
        "basis": (m.Circuit(8).x(0).x(6), None),
        "mcz": (_mcz(m, 8), None),
        "phase_diag": (_phase_diag(m, 8), None),
        "reflect_rot": (_reflect(m, 8, _rotations(8), 173), None),
        "reflect_complex": (_reflect(m, 8, [_haar(rng) for _ in range(8)],
                                     91), None),
        "not_reflect": (_not_reflect(m, 8), None),
        "spanning": (_spanning(m, 8), None),
        "param": (_param(m, 8), np.linspace(0.1, 1.5, 8).astype(np.float32)),
    }


def density_cases(m, k: int) -> dict:
    """{name: (circuit, params or None, mixed initial ρ or None)} of the
    density cases (n = 5: ρ is a 10-qubit register)."""
    return {
        "random": (m.random_circuit(5, 2, seed=7), None, mixed_rho(5, 3)),
        "grover": (m.grover_circuit(5, marked=9, iterations=3), None, None),
        "param": (_param(m, 5), np.linspace(0.2, 1.1, 5).astype(np.float32),
                  mixed_rho(5, 2)),
    }


def mixed_rho(n: int, seed: int) -> np.ndarray:
    """A planar (2, 2^n, 2^n) mixture of three random pure states."""
    rng = np.random.default_rng(seed)
    rho = np.zeros((2**n, 2**n), complex)
    for w in (0.5, 0.3, 0.2):
        v = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
        v /= np.linalg.norm(v)
        rho += w * np.outer(v, v.conj())
    return np.stack([rho.real, rho.imag]).astype(np.float32)


def random_state(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    v /= np.linalg.norm(v)
    return np.stack([v.real, v.imag]).astype(np.float32)


def layout_cases(k: int) -> dict:
    """{name: (n, initial perm, items builder, targets)}: layouts restored
    by BitSwaps and a LocalPerm (``plan_perm_to_identity``), also at the
    tight n = 2k, and targets made local (``plan_reshards_to_localize``)."""
    rng = np.random.default_rng(70 + k)
    return {
        "to_identity": (8, list(rng.permutation(8)), "identity", None),
        "to_identity_tight": (2 * k, list(rng.permutation(2 * k)),
                              "identity", None),
        "localize": (8, list(rng.permutation(8)), "localize", (0, 3, 5)),
    }


def layout_items(module, kind: str, perm, n: int, k: int, targets):
    """(items, final perm) of a layout case, from ``module``'s planner
    (the port's or the reference's ``tpu.sharded``)."""
    if kind == "identity":
        return module.plan_perm_to_identity(perm, n, k)
    return module.plan_reshards_to_localize(perm, n, k, list(targets))


PROGRAMS = {
    "deutsch_sharded": """qset tensorExp(ketToDensity(np_array([1,0])), 5)
gate hadamardGate ; 0
gate hadamardGate ; 1
gate hadamardGate ; 2
gate pauliXGate ; 4
gate hadamardGate ; 4
gate simonsGate(3, lambda x: x % 2) ; 0
meas res ; computation ; [0,1,2]
""",
    "state_prep": """qset tensorProd(ketToDensity(np_array([1,1])/np_sqrt(2)), ketToDensity(np_array([0,1])), tensorExp(ketToDensity(np_array([1,0])), 4))
gate pauliXGate ; 2 ; [1]
meas res ; computation ; [0,1,2]
""",
    "hadamard_basis": """qset tensorExp(ketToDensity(np_array([1,0])), 6)
gate hadamardGate ; 3
meas res ; hadamard ; [3,4]
""",
}
# the example programs that lower
EXAMPLES = ("deutsch.qb", "grover.qb", "phase_kickback.qb", "superdense.qb")


def _shardable(src: str, k: int) -> bool:
    try:
        sharded.compile_sharded(_full_circuit(lower_program(src), 7), k)
    except ValueError:          # too narrow, or no free block to reshard
        return False
    return True


def programs(k: int) -> dict:
    """{name: source} of the programs of PROGRAMS and EXAMPLES that a
    2^k-way register runs."""
    out = dict(PROGRAMS)
    out.update((name, (ROOT / "examples" / name).read_text())
               for name in EXAMPLES)
    return {name: src for name, src in out.items() if _shardable(src, k)}


def _resolve(targets, n):
    return None if targets is None else sorted(q % n for q in targets)


def run_rank(mesh, out_dir: str) -> None:
    """Every case on this rank's shard; rank 0 writes ``<case>.npz``."""
    k, out = mesh.k, Path(out_dir)

    def save(name, **arrays):
        if mesh.rank == 0:
            np.savez(out / f"{name}.npz", **arrays)

    def gathered(psi):
        full = sharded.gather_planar(psi, mesh)
        return None if full is None else full.numpy()

    for name, (circ, params) in state_cases(torch_circuit, k).items():
        splan = sharded.compile_sharded(circ, k)
        run = sharded.make_sharded_planar_runner(splan, mesh)
        theta = None if params is None else torch.from_numpy(params)
        psi = run(sharded.sharded_zero_state(circ.n, mesh), theta)
        arrays = {"state": gathered(psi),
                  "kinds": np.array([type(i).__name__ for i in splan.items])}
        for label, targets in (PROB_TARGETS.items()
                               if name in PROB_CASES else ()):
            probs = sharded.sharded_probs_fn(
                splan, mesh, _resolve(targets, circ.n))(psi)
            arrays[f"probs_{label}"] = probs.numpy()
        save(f"state_{name}", **arrays)

    for name, (n, perm, kind, targets) in layout_cases(k).items():
        items, final = layout_items(sharded, kind, perm, n, k, targets)
        splan = sharded.ShardedPlan(n=n, k=k, items=items, final_perm=final)
        psi0 = sharded.shard_planar(random_state(n, 11 + k), mesh)
        psi = sharded.make_sharded_planar_runner(splan, mesh)(psi0)
        save(f"layout_{name}", state=gathered(psi),
             kinds=np.array([type(i).__name__ for i in items]))

    for name, (circ, params, rho0) in density_cases(torch_circuit, k).items():
        n = circ.n
        splan = sharded.compile_sharded_density(circ, k)
        run = sharded.make_sharded_planar_runner(splan, mesh)
        rho = (sharded.sharded_zero_density(n, mesh) if rho0 is None
               else sharded.shard_density(rho0, mesh))
        theta = None if params is None else torch.from_numpy(params)
        rho = run(rho, theta)
        arrays = {"rho": gathered(rho)}
        if name != "random":
            save(f"density_{name}", **arrays)
            continue
        for label, targets in PROB_TARGETS.items():
            arrays[f"probs_{label}"] = sharded.sharded_density_probs_fn(
                splan, mesh, _resolve(targets, n))(rho).numpy()
        for label, targets in DISCARDS.items():
            reduced, perm = sharded.sharded_density_discard(
                rho, n, k, _resolve(targets, n), mesh,
                perm=splan.final_perm)
            arrays[f"discard_{label}"] = gathered(reduced)
            arrays[f"discard_{label}_perm"] = np.array(perm)
        save(f"density_{name}", **arrays)

    for name, src in programs(k).items():
        probs, _, _ = run_lowered_sharded(lower_program(src), mesh=mesh)
        save(f"program_{name.replace('.', '_')}", probs=probs)


def fail_on_rank(mesh, rank: int) -> None:
    """Raise on ``rank``; the other ranks wait until the run stops them."""
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} fails")
    time.sleep(600)

"""Circuits whose windows and pairs carry fused phases, for the density
executor's tests on the CPU (``tests/test_torch_density.py``) and on the
card (``tests/test_torch_cuda.py``).  Imports neither jax nor ``qbot_tpu``.

Each case is a list of the benchmark's ops (``("gate", targets, matrix,
controls)`` and ``("flip", m)``, as ``portbench/families`` make them), so
the plain complex128 reference ``portbench/reference/density.py`` runs the
same gates, and a window width to compile them at.  Controls sit in the
first qubits and targets in the last window, so every controlled phase
crosses a window boundary and the compiler fuses it into the next window
or pair.
"""
import numpy as np

# diagonal entries the kernels look up in tables a launch
# (``qbot_tpu_torch/csrc/tc_tile.cuh``); more go through a loop
TABLE = 8

H = np.array([[1, 1], [1, -1]], np.complex128) / np.sqrt(2)
S = np.diag([1, 1j]).astype(np.complex128)
T = np.diag([1, np.exp(1j * np.pi / 4)]).astype(np.complex128)


def haar_layer(n, rng):
    out = []
    for q in range(n):
        z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
        qm, r = np.linalg.qr(z)
        out.append(("gate", (q,), qm * np.conj(r.diagonal()
                                               / np.abs(r.diagonal())), ()))
    return out


def hermitian_factors(n, seed):
    """n random one-qubit density matrices (Hermitian, trace 1)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
        r = a @ a.conj().T
        out.append(r / np.trace(r))
    return out


def _controlled(gate, control, target):
    return ("gate", (target,), gate, (control,))


def complex_phases(n, rng):
    """Controlled-S and controlled-T across the boundary, twice: z ≠ z̄,
    so a column side that took z in place of conj(z) shows."""
    ops = haar_layer(n, rng)
    for _ in range(2):
        ops += [_controlled(S, 1, n - 5), _controlled(T, 0, n - 6),
                _controlled(T, n - 4, 1)]
        ops += haar_layer(n, rng)
    return ops


def phase_and_flips(n, rng):
    """A controlled-S, a flip and a controlled-T fuse into one window: its
    row launch carries the flip's rows and columns beside the phases."""
    return (haar_layer(n, rng)
            + [_controlled(S, 1, n - 5), ("flip", 37),
               _controlled(T, 0, n - 4)]
            + haar_layer(n, rng))


def reflection(n, rng):
    """A diffusion (H, flip 0, H) after a phase and a flip, which stay
    standalone before the reflection; the density executor runs the
    reflection as its windows and flip, and a controlled-T after it fuses
    into the next pair."""
    hs = [("gate", (q,), H, ()) for q in range(n)]
    return (haar_layer(n, rng) + [_controlled(S, 0, n - 1), ("flip", 5)]
            + hs + [("flip", 0)] + hs + [_controlled(T, 1, n - 1)]
            + haar_layer(n, rng))


def over_table(n, rng):
    """Five controlled phases and a flip on one window: 2 × 5 + 2 = 12
    entries in its row launch, more than TABLE."""
    ops = haar_layer(n, rng)
    for k, (c, t) in enumerate([(0, n - 6), (1, n - 5), (0, n - 4),
                                (1, n - 3), (0, n - 2)]):
        ops.append(_controlled(T if k % 2 else S, c, t))
    ops.append(("flip", 3))
    return ops + haar_layer(n, rng)


# name -> (ops of (n, rng), window)
CASES = {
    "complex_phases": (complex_phases, 1),
    "phase_and_flips": (phase_and_flips, 2),
    "reflection": (reflection, 2),
    "over_table": (over_table, 2),
}


def circuit(m, n, ops):
    """``m.Circuit`` (either package's ``tpu.circuit``) of ``ops``."""
    c = m.Circuit(n)
    for op in ops:
        if op[0] == "flip":
            c.phase_flip(op[1])
        else:
            _, targets, matrix, controls = op
            c.gate(matrix, list(targets), list(controls))
    return c


def fused_windows(steps):
    """The windows whose fused flips and phases a density row launch
    takes: each window, and each pair's first."""
    for step in steps:
        w = getattr(step, "first", step)
        if hasattr(w, "pre_phases"):
            yield w


def row_entries(window) -> int:
    """Diagonal entries of a window's density row launch: each phase on
    the rows and on the columns, each flip likewise."""
    return 2 * (len(window.pre_phases) + len(window.pre_flips))


def engages(name, plan) -> bool:
    """The plan has what case ``name`` is there to test."""
    wins = list(fused_windows(plan.steps))
    if name == "complex_phases":
        return any(complex(z).imag for w in wins for _, z, _ in w.pre_phases)
    if name == "phase_and_flips":
        return any(w.pre_phases and w.pre_flips for w in wins)
    if name == "reflection":
        return (any(type(s).__name__ == "ReflectStep" for s in plan.steps)
                and any(w.pre_phases for w in wins))
    return any(row_entries(w) > TABLE for w in wins)

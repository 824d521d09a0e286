"""Circuit IR: the device-side program representation.

The DSL front-end (and any Python embedder) lowers numeric work to this IR,
which the window-fusion compiler (:mod:`qbot_tpu_torch.tpu.compiler`) turns into a
static execution plan for the planar executor.  The reference has no such layer — every
`gate` line rebuilds a full-space operator (reference qgates.py:161-182);
here a circuit is compiled once and replayed at HBM speed.

Ops:
* ``gate``     — k-qubit unitary on arbitrary targets, optional controls,
                 optionally parameterised (for HMC over gate angles).
* ``diagonal`` — diagonal unitary given by its phase vector on a target
                 subset (one elementwise pass; covers multi-controlled-Z /
                 Grover oracles without materialising 2^n matrices).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from qbot_tpu_torch.ops import gates as g

__all__ = ["CircuitOp", "Circuit", "grover_circuit", "qft_circuit",
           "random_circuit", "parameterized_layers"]


@dataclass(frozen=True)
class CircuitOp:
    kind: str                      # 'gate' | 'diag' | 'flip'
    targets: tuple[int, ...]
    controls: tuple[int, ...] = ()
    matrix: Optional[np.ndarray] = None      # static unitary / diag vector
    param_idx: Optional[int] = None          # index into the params vector
    maker: Optional[Callable] = None         # theta -> planar matrix (torch)
    index: Optional[int] = None              # basis state for 'flip'


@dataclass
class Circuit:
    """A qubit-count plus an ordered op list, with fluent builders."""

    n: int
    ops: list[CircuitOp] = field(default_factory=list)
    num_params: int = 0

    # -- generic -----------------------------------------------------------

    def gate(self, matrix: np.ndarray, targets: Sequence[int],
             controls: Sequence[int] = ()) -> "Circuit":
        self.ops.append(CircuitOp("gate", tuple(targets), tuple(controls),
                                  np.asarray(matrix)))
        return self

    def param_gate(self, maker: Callable, targets: Sequence[int],
                   controls: Sequence[int] = (),
                   param_idx: Optional[int] = None) -> "Circuit":
        """Gate whose matrix is ``maker(params[param_idx])`` at run time."""
        if param_idx is None:
            param_idx = self.num_params
        self.num_params = max(self.num_params, param_idx + 1)
        self.ops.append(CircuitOp("gate", tuple(targets), tuple(controls),
                                  None, param_idx, maker))
        return self

    def diagonal(self, diag: np.ndarray, targets: Sequence[int]) -> "Circuit":
        self.ops.append(CircuitOp("diag", tuple(targets), (),
                                  np.asarray(diag)))
        return self

    # -- named single/two-qubit builders -----------------------------------

    def h(self, q: int):
        return self.gate(g.hadamard(), [q])

    def x(self, q: int):
        return self.gate(g.pauli_x(), [q])

    def y(self, q: int):
        return self.gate(g.pauli_y(), [q])

    def z(self, q: int):
        return self.gate(g.pauli_z(), [q])

    def s(self, q: int):
        return self.gate(np.diag([1, 1j]).astype(complex), [q])

    def t(self, q: int):
        return self.gate(np.diag([1, np.exp(1j * np.pi / 4)]), [q])

    def rx(self, q: int, theta: float):
        return self.gate(np.asarray(g.rot_x(theta)), [q])

    def ry(self, q: int, theta: float):
        return self.gate(np.asarray(g.rot_y(theta)), [q])

    def rz(self, q: int, theta: float):
        return self.gate(np.asarray(g.rot_z(theta)), [q])

    def prx(self, q: int, param_idx: Optional[int] = None):
        return self.param_gate(lambda t: g.rot_planar("x", t, xp=torch),
                               [q], param_idx=param_idx)

    def pry(self, q: int, param_idx: Optional[int] = None):
        return self.param_gate(lambda t: g.rot_planar("y", t, xp=torch),
                               [q], param_idx=param_idx)

    def prz(self, q: int, param_idx: Optional[int] = None):
        return self.param_gate(lambda t: g.rot_planar("z", t, xp=torch),
                               [q], param_idx=param_idx)

    def cx(self, control: int, target: int):
        return self.gate(g.pauli_x(), [target], [control])

    def cz(self, control: int, target: int):
        return self.gate(g.pauli_z(), [target], [control])

    def swap(self, a: int, b: int):
        m = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                     dtype=complex)
        return self.gate(m, [a, b])

    def phase_flip(self, basis_state: int):
        """Multi-controlled-Z flipping the sign of one basis state.

        Stored as an index, not a dense 2^n diagonal — at 26 qubits a dense
        diag constant would be baked into the HLO (and rejected by the
        remote compiler); the executors lower this to a single-element
        scatter instead.
        """
        self.ops.append(CircuitOp("flip", tuple(range(self.n)),
                                  index=int(basis_state)))
        return self

    # -- stats -------------------------------------------------------------

    @property
    def gate_count(self) -> int:
        """Logical gate count (a diagonal on k qubits counts as one gate)."""
        return len(self.ops)


# ---------------------------------------------------------------------------
# circuit library
# ---------------------------------------------------------------------------

def grover_circuit(n: int, marked: int, iterations: Optional[int] = None
                   ) -> Circuit:
    """Grover search: |0..0⟩ → amplified |marked⟩ (BASELINE config 4)."""
    if iterations is None:
        iterations = max(1, int(np.floor(np.pi / 4 * np.sqrt(2**n))))
    c = Circuit(n)
    for q in range(n):
        c.h(q)
    for _ in range(iterations):
        c.phase_flip(marked)            # oracle
        for q in range(n):              # diffusion = H^n · flip(|0..0⟩) · H^n
            c.h(q)
        c.phase_flip(0)                 # == X^n·MCZ·X^n up to global phase
        for q in range(n):
            c.h(q)
    return c


def qft_circuit(n: int) -> Circuit:
    """Textbook QFT: Hadamards + controlled phase rotations + reversal."""
    c = Circuit(n)
    for q in range(n):
        c.h(q)
        for j in range(q + 1, n):
            theta = np.pi / (2 ** (j - q))
            c.gate(np.diag([1, np.exp(1j * theta)]), [q], [j])
    for q in range(n // 2):
        c.swap(q, n - 1 - q)
    return c


def random_circuit(n: int, depth: int, seed: int = 0) -> Circuit:
    """Haar-ish random layers of 1q rotations + CX ladder (benchmark fodder)."""
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    for layer in range(depth):
        for q in range(n):
            c.rx(q, float(rng.uniform(0, 2 * np.pi)))
            c.rz(q, float(rng.uniform(0, 2 * np.pi)))
        for q in range(layer % 2, n - 1, 2):
            c.cx(q, q + 1)
    return c


def parameterized_layers(n: int, depth: int) -> Circuit:
    """Ansatz for HMC/SMC posteriors over gate angles (BASELINE config 5)."""
    c = Circuit(n)
    k = 0
    for layer in range(depth):
        for q in range(n):
            c.pry(q, k)
            k += 1
        for q in range(layer % 2, n - 1, 2):
            c.cx(q, q + 1)
    return c

"""Measurement bases.

Capability parity with the reference's ``qbot/basis.py``
(qbot/basis.py:5-64): a ``Basis`` bundles named kets with
their projectors and ket symbols; three built-ins (computation, hadamard,
bell) are registered into the expression namespace under every alias.
"""
from __future__ import annotations

import numpy as np

from qbot_tpu_torch.helpers import int_log2
from qbot_tpu_torch.ops.core import ket_to_density

__all__ = ["Basis", "computation", "hadamard", "bell", "ALL_BASES"]


class Basis:
    __slots__ = (
        "names", "kets", "density", "ketSymbols", "numQubits", "gateSymbol",
        "projectors",
    )

    def __init__(self, names, kets, ket_symbols, gate_symbol):
        if len(ket_symbols) != len(kets):
            raise ValueError("basis needs one ket symbol per ket")
        self.names = names
        self.kets = kets
        self.ketSymbols = ket_symbols
        self.gateSymbol = gate_symbol
        self.numQubits = int_log2(kets[0].shape[0])
        self.density = [ket_to_density(k) for k in kets]
        # Stacked projector tensor (outcomes, d, d) — the batched form the
        # measurement engine contracts against in one einsum.
        self.projectors = np.stack(self.density)

    def __getitem__(self, i):
        return self.density[i]

    def __len__(self):
        return len(self.density)

    def __repr__(self):
        return f"Basis({self.names[0]}, {len(self.density)} states)"


_R2 = 2 ** (-0.5)

computation = Basis(
    ["comp", "computation", "computational", "compBasis", "computationBasis",
     "computationalBasis"],
    [np.array([1, 0], dtype=complex), np.array([0, 1], dtype=complex)],
    ["|0〉", "|1〉"],
    "∡",
)

hadamard = Basis(
    ["hadamard", "had", "hada", "hadamardBasis", "hadBasis", "hadaBasis"],
    [_R2 * np.array([1, 1], dtype=complex), _R2 * np.array([1, -1], dtype=complex)],
    ["|+〉", "|-〉"],
    "∡ ±",
)

bell = Basis(
    ["bell", "epr", "bellBasis", "eprBasis"],
    [
        _R2 * np.array([1, 0, 0, 1], dtype=complex),
        _R2 * np.array([0, 1, 1, 0], dtype=complex),
        _R2 * np.array([1, 0, 0, -1], dtype=complex),
        _R2 * np.array([0, 1, -1, 0], dtype=complex),
    ],
    ["|β₀₀〉", "|β₀₁〉", "|β₁₀〉", "|β₁₁〉"],
    "∡ β",
)

ALL_BASES = [computation, hadamard, bell]

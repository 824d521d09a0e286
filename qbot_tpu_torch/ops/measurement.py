"""Projective measurement engine.

Capability parity with the reference's ``qbot/measurement.py``
(qbot/measurement.py:10-165): measure an arbitrary subset of
qubits in an arbitrary (possibly multi-qubit, e.g. bell) basis, producing a
``MeasurementResult`` with outcome probabilities, projectors, ket-symbol
strings, and the collapsed post-measurement register.

TPU-first design difference: the reference loops over all
``len(basis)^(targets/basisQubits)`` outcomes computing one trace each
(measurement.py:147-155).  Here the full outcome distribution is produced by
a *single batched einsum* over per-slot outcome axes, and the collapsed
mixture by a second one — no Python outcome loop in the probability path.

Reference defect fixed (SURVEY.md §2.3): ``MeasurementResult.fromProbVal``
asserted on a class annotation and mis-indexed its accumulation loop
(measurement.py:43,54-55) so ProbVal-targeted ``meas`` always crashed; the
merge here is correct, making ProbVal targets fully supported.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from qbot_tpu_torch.basis import Basis
from qbot_tpu_torch.helpers import int_log2, require_square
from qbot_tpu_torch.ops.core import (
    empty_state,
    interweave,
    mix_densities,
    partial_trace_split,
    tensor_product,
)
from qbot_tpu_torch.probval import PROB_DECIMALS, ProbVal

__all__ = [
    "MeasurementResult",
    "MeasurementIndexError",
    "measure",
    "tensor_permute",
    "outcome_projectors",
]


class MeasurementIndexError(Exception):
    """A measurement target is outside the register; args = (msg, target, lo, hi)."""


class MeasurementResult:
    __slots__ = ("unMeasuredDensity", "probs", "basisDensity", "basisSymbols",
                 "newState")

    def __init__(self, un_measured_density, probs, basis_density, basis_symbols,
                 new_state=None):
        self.unMeasuredDensity = un_measured_density
        total = sum(probs)
        self.probs = [round(p / total, PROB_DECIMALS) for p in probs]
        self.basisDensity = basis_density
        self.basisSymbols = basis_symbols
        self.newState = new_state

    def __repr__(self):
        # byte-compatible with the reference readout (measurement.py:31-35);
        # README.md:185-188 shows the exact expected output format.
        out = ""
        for prob, sym in zip(self.probs, self.basisSymbols):
            out += f"{sym}- {prob} ({prob * 100}%)\n"
        return out

    def __getitem__(self, i):
        return self.probs[i]

    def toDensity(self):
        return mix_densities(self.probs, self.basisDensity)

    @staticmethod
    def from_probval(pv: ProbVal) -> "MeasurementResult":
        """Merge MeasurementResults across ProbVal branches.

        Outcome probabilities are the branch-weighted average; the
        unmeasured / collapsed densities are the branch-weighted mixtures.
        All branches are assumed to share a basis.
        """
        branches = pv.values
        if not branches:
            raise ValueError("empty ProbVal of measurements")
        for m in branches:
            if not isinstance(m, MeasurementResult):
                raise TypeError("expected ProbVal<MeasurementResult>")
        n_outcomes = len(branches[0].probs)
        merged = [0.0] * n_outcomes
        for w, m in zip(pv.probs, branches):
            if len(m.probs) != n_outcomes:
                raise ValueError("branch measurements have mismatched outcomes")
            for j, p in enumerate(m.probs):
                merged[j] += w * p
        un_measured = mix_densities(pv.probs, [m.unMeasuredDensity for m in branches])
        first = branches[0]
        if first.newState is not None:
            new_state = mix_densities(pv.probs, [m.newState for m in branches])
            return MeasurementResult(un_measured, merged, first.basisDensity,
                                     first.basisSymbols, new_state)
        return MeasurementResult(un_measured, merged, first.basisDensity,
                                 first.basisSymbols)

    fromProbVal = from_probval


def _digits_big_endian(n: int, base: int, width: int) -> list[int]:
    out = []
    for _ in range(width):
        out.append(n % base)
        n //= base
    return out[::-1]


def tensor_permute(num_tens_prod: int, n: int, d: Union[Sequence, Basis], xp=np):
    """The n-th tensor-product permutation of states drawn from ``d``.

    ``n`` is read base-``len(d)`` big-endian, mapping digits left-to-right
    onto tensor factors: ``tensor_permute(3, 2, comp) ==
    comp[0] ⊗ comp[1] ⊗ comp[0]`` (reference semantics,
    measurement.py:72-86).
    """
    if isinstance(d, Basis):
        d = d.density
    digits = _digits_big_endian(n, len(d), num_tens_prod)
    return tensor_product(*[d[i] for i in digits], xp=xp)


def outcome_projectors(basis: Basis, num_slots: int, xp=np):
    """Stack of all ``len(basis)**num_slots`` outcome projectors.

    Returned as an array of shape ``(b**m, D, D)`` with ``D = d**m`` built by
    one einsum over per-slot outcome axes (C-order flattening matches the
    big-endian outcome enumeration).
    """
    P = xp.asarray(basis.projectors)  # (b, d, d)
    b, d, _ = P.shape
    if num_slots == 1:
        return P
    operands = []
    idx = []
    for k in range(num_slots):
        operands += [P, [k, num_slots + k, 2 * num_slots + k]]
    out_idx = (list(range(num_slots))
               + list(range(num_slots, 2 * num_slots))
               + list(range(2 * num_slots, 3 * num_slots)))
    full = xp.einsum(*operands, out_idx)
    D = d**num_slots
    return full.reshape(b**num_slots, D, D)


def _outcome_probs(rho_a, basis: Basis, num_slots: int, xp=np):
    """All outcome probabilities |Tr(ρ_A P_o)| in one batched einsum."""
    P = xp.asarray(basis.projectors)
    d = P.shape[1]
    bq = int_log2(d)
    m = num_slots
    rho_t = rho_a.reshape((d,) * (2 * m))
    # indices: rho rows r_k -> k, cols c_k -> m+k; P_k gets (o_k, c_k, r_k)
    operands = [rho_t, list(range(2 * m))]
    for k in range(m):
        operands += [P, [2 * m + k, m + k, k]]
    out_idx = [2 * m + k for k in range(m)]
    probs = xp.einsum(*operands, out_idx)
    return xp.abs(probs.reshape(-1))


def measure(state, basis: Basis, targets=None, collapse: bool = True, xp=np):
    """Measure ``targets`` of ``state`` in ``basis``.

    ``targets=None`` measures the whole register.  With ``collapse=True`` the
    result carries the post-measurement register (outcome mixture
    re-interleaved with the untouched subsystem); ``collapse=False`` is the
    ``peek`` path.
    """
    n = int_log2(require_square(state))
    if targets is None:
        target_list = list(range(n))
    else:
        target_list = sorted(set(targets))
        for t in target_list:
            if t < 0 or t > n - 1:
                raise MeasurementIndexError(
                    f"measurement target {t} outside of valid range [0, {n - 1}]",
                    t, 0, n - 1,
                )
    num_targets = len(target_list)
    if num_targets == 0:
        raise ValueError("measurement must have targets")

    bq = basis.numQubits
    if num_targets % bq != 0:
        raise ValueError(
            f"number of qubits to measure {num_targets} must be divisable by "
            f"the number of qubits in the basis states {bq}"
        )

    if num_targets == n:
        system_a, system_b = state, empty_state(xp=xp)
    else:
        system_a, system_b = partial_trace_split(state, target_list, xp=xp)

    m = num_targets // bq
    probs = _outcome_probs(system_a, basis, m, xp=xp)
    probs = probs / probs.sum()

    projectors = outcome_projectors(basis, m, xp=xp)
    basis_states = list(projectors)
    symbols = ["".join(basis.ketSymbols[d] for d in _digits_big_endian(i, len(basis), m))
               for i in range(len(basis) ** m)]
    prob_list = [float(p) for p in probs]

    if not collapse:
        return MeasurementResult(system_a, prob_list, basis_states, symbols)

    measured = xp.einsum("o,oij->ij", probs, projectors)
    if getattr(system_b, "size", 0) == 0:
        new_state = measured
    else:
        new_state = interweave(measured, system_b, target_list, xp=xp)
    return MeasurementResult(system_a, prob_list, basis_states, symbols, new_state)

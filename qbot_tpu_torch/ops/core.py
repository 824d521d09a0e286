"""Core tensor algebra for the quantum register.

This is the L1 engine of the framework (capability parity with the
reference's ``qbot/density.py`` + ``qbot/qgates.py`` application path — see
qbot/density.py:7-240 and qgates.py:278-279) designed
TPU-first:

* The register is viewed as a rank-``2n`` tensor of shape ``(2,)*2n`` (density
  mode) or rank-``n`` ``(2,)*n`` (pure mode).  Qubit ``i`` is the ``i``-th
  (most-significant-first) tensor axis, matching the reference's kron order.
* Gates are applied by **axis contraction** (``tensordot`` + ``moveaxis``) on
  the target qubit axes only — O(4^n · 2^k) for a k-qubit gate on an n-qubit
  density matrix — never by materialising a 2^n×2^n full-space operator the
  way the reference does (qgates.py:161-182, an O(8^n) pattern).
* Qubit permutations (partial trace / replace / interweave) are pure
  ``moveaxis``/``einsum`` relabelings, never permutation matrices
  (cf. reference ``genArbitrarySwap`` conjugations, density.py:122-148).
* Every function is written against a generic array namespace ``xp``; in
  this package that is NumPy (the complex128 conformance oracle, see
  :mod:`qbot_tpu_torch.backend`).
"""
from __future__ import annotations

from functools import reduce
from typing import Sequence

import numpy as np

from qbot_tpu_torch.helpers import int_log2, require_square

__all__ = [
    "num_qubits",
    "empty_state",
    "tensor_product",
    "tensor_power",
    "ket_to_density",
    "kets_to_density",
    "kets_to_density_zipped",
    "mix_densities",
    "normalize_density",
    "apply_gate",
    "apply_gate_targets",
    "apply_gate_state",
    "controlled_matrix",
    "apply_controlled",
    "partial_trace_split",
    "partial_trace_keep",
    "interweave",
    "replace_qubits",
    "density_to_ensemble",
    "pure_to_density_tensor",
]


def num_qubits(state) -> int:
    """Number of qubits represented by a state matrix (0 for the empty register)."""
    if state is None or getattr(state, "size", 0) == 0 or state.ndim == 0:
        return 0
    return int_log2(state.shape[0])


def empty_state(xp=np, dtype=complex):
    return xp.zeros((0,), dtype=dtype)


def tensor_product(*factors, xp=np):
    """Kronecker product of any number of factors; empty arrays are skipped.

    ``tensor_product()`` returns the empty register (parity with reference
    ``tensorProd``, density.py:7-24).
    """
    real = [f for f in factors if getattr(f, "size", 0) != 0]
    if not real:
        return empty_state(xp=xp)
    return reduce(xp.kron, real)


def tensor_power(mat, n: int, xp=np):
    if n == 0:
        return xp.eye(mat.shape[0], dtype=mat.dtype)
    return tensor_product(*([mat] * n), xp=xp)


def ket_to_density(ket, xp=np):
    return xp.outer(ket, xp.conj(ket))


def kets_to_density(kets: Sequence, probs: Sequence[float] | None = None, xp=np):
    if probs is None:
        return ket_to_density(kets[0], xp=xp)
    if len(kets) != len(probs):
        raise ValueError("kets and probs must have the same length")
    return sum(p * ket_to_density(k, xp=xp) for p, k in zip(probs, kets))


def kets_to_density_zipped(pairs, xp=np):
    if len(pairs) == 0:
        return empty_state(xp=xp)
    return sum(p * ket_to_density(k, xp=xp) for p, k in pairs)


def mix_densities(probs: Sequence[float], densities: Sequence, xp=np):
    """Probability-weighted mixture Σ pᵢ ρᵢ."""
    if len(probs) != len(densities):
        raise ValueError("probs and densities must have the same length")
    out = probs[0] * densities[0]
    for p, d in zip(probs[1:], densities[1:]):
        out = out + p * d
    return out


def normalize_density(rho, xp=np):
    return rho / xp.trace(rho)


# ---------------------------------------------------------------------------
# Gate application by axis contraction
# ---------------------------------------------------------------------------

def _as_tensor(mat, n: int, sides: int):
    """View a 2^n(×2^n) array as a rank-(sides·n) tensor of 2s."""
    return mat.reshape((2,) * (sides * n))


def _contract_axes(tensor, gate_t, axes: Sequence[int], total_axes: int, xp):
    """Contract ``gate_t`` (rank-2k) into ``tensor`` over ``axes``, restoring layout."""
    k = len(axes)
    out = xp.tensordot(gate_t, tensor, axes=(list(range(k, 2 * k)), list(axes)))
    # tensordot puts the k gate output axes first and the surviving tensor axes
    # after, in ascending original order; moveaxis restores the original slots.
    return xp.moveaxis(out, list(range(k)), list(axes))


def apply_gate_targets(rho, gate, targets: Sequence[int], xp=np):
    """Apply a k-qubit unitary to arbitrary qubit positions of a density matrix.

    ρ' = U ρ U† computed as two axis contractions over the target axes.
    ``targets`` may be any distinct qubit indices in any order; ``gate`` is a
    2^k × 2^k matrix whose qubit ``j`` acts on ``targets[j]``.
    """
    n = num_qubits(rho)
    k = len(targets)
    if k == 0:
        return rho
    t = _as_tensor(rho, n, 2)
    g = _as_tensor(gate, k, 2)
    t = _contract_axes(t, g, list(targets), 2 * n, xp)
    col_axes = [n + q for q in targets]
    t = _contract_axes(t, xp.conj(g), col_axes, 2 * n, xp)
    return t.reshape(rho.shape)


def apply_gate(gate, rho, xp=np):
    """Reference-compatible signature: gate spans the whole register.

    Equivalent to the reference's ``applyGate`` (qgates.py:278-279) but via
    contraction; accepts a full-space 2^n × 2^n gate.
    """
    n = num_qubits(rho)
    return apply_gate_targets(rho, gate, list(range(n)), xp=xp)


def apply_gate_state(psi, gate, targets: Sequence[int], xp=np):
    """Apply a k-qubit unitary to a pure state vector (rank-n tensor path)."""
    n = int_log2(psi.shape[0])
    k = len(targets)
    if k == 0:
        return psi
    t = _as_tensor(psi, n, 1)
    g = _as_tensor(gate, k, 2)
    t = _contract_axes(t, g, list(targets), n, xp)
    return t.reshape(psi.shape)


def controlled_matrix(gate, num_controls: int, xp=np):
    """Block-diagonal controlled operator on (controls..., targets...) qubits.

    Identity except the bottom-right 2^k block, which is ``gate``.  Combined
    with :func:`apply_gate_targets` on the qubit list ``controls + targets``
    this subsumes the reference's swap/shift-conjugation construction
    (qgates.py:185-275) with no full-space intermediates.
    """
    size = gate.shape[0]
    dim = (2**num_controls) * size
    out = xp.eye(dim, dtype=gate.dtype)
    if xp is np:
        out[dim - size:, dim - size:] = gate
        return out
    return out.at[dim - size:, dim - size:].set(gate)


def apply_controlled(rho, gate, targets: Sequence[int], controls: Sequence[int], xp=np):
    """Apply ``gate`` on ``targets`` controlled on all of ``controls`` being |1⟩."""
    if not controls:
        return apply_gate_targets(rho, gate, targets, xp=xp)
    cg = controlled_matrix(gate, len(controls), xp=xp)
    return apply_gate_targets(rho, cg, list(controls) + list(targets), xp=xp)


# ---------------------------------------------------------------------------
# Partial trace / qubit rearrangement
# ---------------------------------------------------------------------------

def partial_trace_split(rho, targets: Sequence[int], xp=np):
    """Split ρ into (ρ_targets, ρ_rest) by tracing out the complement of each.

    Output qubit order within each factor is ascending (parity with the
    reference's ``partialTraceArbitrary``, density.py:122-148, which sorts its
    target list).  Implemented as two einsum traces on the rank-2n view —
    no permutation matrices.
    """
    n = num_qubits(rho)
    keep = sorted(set(targets))
    rest = [q for q in range(n) if q not in keep]
    return (_trace_to(rho, n, keep, rest, xp), _trace_to(rho, n, rest, keep, xp))


def partial_trace_keep(rho, keep: Sequence[int], xp=np):
    """Density matrix of the ``keep`` qubits (ascending order)."""
    n = num_qubits(rho)
    keep = sorted(set(keep))
    rest = [q for q in range(n) if q not in keep]
    return _trace_to(rho, n, keep, rest, xp)


def _trace_to(rho, n: int, keep: list[int], traced: list[int], xp):
    if not keep:
        return empty_state(xp=xp)
    t = _as_tensor(rho, n, 2)
    # einsum integer-index form: row axis of qubit q gets index q, col axis
    # gets n+q for kept qubits and q (same as row → traced) otherwise.
    idx = [0] * (2 * n)
    for q in range(n):
        idx[q] = q
        idx[n + q] = q if q in traced else n + q
    out_idx = keep + [n + q for q in keep]
    t = xp.einsum(t, idx, out_idx)
    d = 2 ** len(keep)
    return t.reshape(d, d)


def interweave(a, b, a_positions: Sequence[int], xp=np):
    """Combine two subsystems, placing ``a``'s qubits at sorted(a_positions).

    ``b``'s qubits fill the remaining slots in ascending order (parity with
    reference ``interweaveDensities``, density.py:150-192).  Pure moveaxis.
    """
    if getattr(b, "size", 0) == 0:
        return a
    if getattr(a, "size", 0) == 0:
        return b
    na, nb = num_qubits(a), num_qubits(b)
    n = na + nb
    pos_a = sorted(set(a_positions))
    if len(pos_a) != na:
        raise ValueError("number of positions must match subsystem size")
    pos_b = [q for q in range(n) if q not in pos_a]
    combined = xp.kron(a, b)
    return _permute_qubits(combined, n, pos_a + pos_b, xp)


def _permute_qubits(rho, n: int, dest: list[int], xp):
    """Move qubit ``i`` of ``rho`` to position ``dest[i]`` (rows and columns)."""
    t = _as_tensor(rho, n, 2)
    src = list(range(n)) + [n + q for q in range(n)]
    dst = dest + [n + q for q in dest]
    t = xp.moveaxis(t, src, dst)
    return t.reshape(rho.shape)


def replace_qubits(rho, new, targets: Sequence[int], xp=np):
    """Replace the ``targets`` qubits of ρ with the state ``new``.

    Traces out ``targets``, then interleaves ``new`` back at those positions
    (``new``'s qubit j lands on ``targets[j]``; parity with reference
    ``replaceArbitrary``, density.py:195-227, generalised to unsorted target
    lists).
    """
    n = num_qubits(rho)
    n_new = num_qubits(new)
    targets = list(targets)
    if len(targets) != n_new:
        raise ValueError(
            f"number of target qubits {len(targets)} does not equal "
            f"number of provided qubits {n_new}"
        )
    rest = partial_trace_keep(rho, [q for q in range(n) if q not in targets], xp=xp)
    if getattr(rest, "size", 0) == 0:
        combined = new
        src_order = targets
    else:
        combined = xp.kron(rest, new)
        rest_positions = [q for q in range(n) if q not in targets]
        src_order = rest_positions + targets
    return _permute_qubits(combined, n, src_order, xp)


def density_to_ensemble(rho, xp=np):
    """Eigendecomposition of ρ as a list of (probability, ket) pairs."""
    require_square(rho)
    vals, vecs = np.linalg.eig(np.asarray(rho))
    return [(abs(v), vecs[:, i]) for i, v in enumerate(vals) if v != 0]


def pure_to_density_tensor(val, xp=np):
    """Coerce a ket (1-D) to a density matrix; pass density matrices through."""
    if val.ndim == 1:
        return ket_to_density(val, xp=xp)
    return val

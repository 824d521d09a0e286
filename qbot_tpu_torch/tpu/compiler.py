"""Window-fusion circuit compiler without JAX.

The integer-window branch of :func:`qbot_tpu.tpu.compiler.compile_circuit`
and its reflection detection, which in the JAX package folds window
matrices through :mod:`qbot_tpu.tpu.planar` and so imports JAX.  Here the
fold comes from :mod:`qbot_tpu_torch.tpu.planar`.  The plan dataclasses
and every other pass are imported from :mod:`qbot_tpu.tpu.compiler`, so a
plan from either compiler runs on either executor.

Windows are paired by default, as in ``qbot_tpu``: adjacent windows that
``qbot_tpu.tpu.compiler._pairable`` accepts become one ``PairStep`` (one
pass of the pair kernel).  Plans equal ``qbot_tpu``'s
``compile_circuit(circ, window, pair)`` step for step, for both values of
``pair``.  There is no ``window="auto"``: ranking widths needs cost
constants measured on the card.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from qbot_tpu.ops.gates import controlled
from qbot_tpu.tpu.circuit import Circuit
from qbot_tpu.tpu.compiler import (
    ContractStep,
    DiagStep,
    FlipStep,
    PhaseStep,
    Plan,
    ReflectStep,
    Step,
    Term,
    WindowStep,
    _fuse_flips,
    _fuse_phases,
    _pair_windows,
    decompose_spanning_swap,
    eigen_decompose_controlled,
    gate_as_diag,
    merge_adjacent_diags,
)
from qbot_tpu_torch.tpu.planar import fold_window_static

__all__ = ["compile_circuit"]

_LANE_LOG2 = 7     # width of the trailing window


def compile_circuit(circ: Circuit, window: int = 7,
                    pair: bool = True) -> Plan:
    """Compile to a window-fused plan of windows of up to ``window``
    qubits (``qbot_tpu/tpu/compiler.py:536-694``), with adjacent windows
    paired when ``pair``."""
    if not isinstance(window, int):
        raise ValueError(f"window must be an integer width, got {window!r}")
    n = circ.n
    w = min(window, n) if n else 1
    # the last window has width min(n, 7); the front qubits split
    # end-aligned into windows of width w, the remainder first
    last_w = min(n, _LANE_LOG2)
    front = n - last_w
    rem = front % w
    bounds = ([(0, rem)] if rem else []) + [
        (rem + i * w, w) for i in range(front // w)]
    if last_w:
        bounds.append((front, last_w))
    group_of = [0] * n
    for gi, (start, width) in enumerate(bounds):
        for q in range(start, start + width):
            group_of[q] = gi

    plan = Plan(n=n, window=w, num_params=circ.num_params,
                gate_count=circ.gate_count)
    pending: dict[int, list[Term]] = {}
    pending_support: dict[int, set[int]] = {}

    def fold(gi: int, qubits, term: Term) -> None:
        pending.setdefault(gi, []).append(term)
        pending_support.setdefault(gi, set()).update(qubits)

    def flush(gi: int) -> None:
        terms = pending.pop(gi, None)
        pending_support.pop(gi, None)
        if terms:
            plan.steps.append(WindowStep(bounds[gi][0], bounds[gi][1],
                                         tuple(terms)))

    def flush_overlapping(qubits) -> None:
        # a pending window flushes before a spanning step only if its
        # terms share support with it: disjoint supports commute
        qs = set(qubits)
        for gi in sorted(g for g, sup in list(pending_support.items())
                         if sup & qs):
            flush(gi)

    def local(gi: int, qubits) -> tuple[int, ...]:
        return tuple(q - bounds[gi][0] for q in qubits)

    queue = deque(circ.ops)
    while queue:
        op = queue.popleft()
        dop = gate_as_diag(op)
        if dop is not None:
            op = dop
        if op.kind == "flip":
            flush_overlapping(op.targets)
            plan.steps.append(FlipStep(op.index))
            continue
        if op.kind == "diag":
            targets = op.targets
            gis = {group_of[q] for q in targets}
            if len(gis) == 1:
                gi = next(iter(gis))
                fold(gi, targets, Term(local(gi, targets),
                                       np.diag(op.matrix).astype(
                                           np.complex128)))
            else:
                d = np.asarray(op.matrix, np.complex128)
                flush_overlapping(targets)
                nontriv = np.flatnonzero(
                    ~np.isclose(d, 1.0, rtol=0.0, atol=1e-12))
                if (nontriv.shape[0] == 1
                        and abs(abs(d[nontriv[0]]) - 1.0) < 1e-12):
                    # controlled-phase normal form: fuses into the next
                    # window kernel instead of costing a pass
                    idx = int(nontriv[0])
                    plan.steps.append(
                        PhaseStep(targets, complex(d[idx]), idx))
                else:
                    plan.steps.append(DiagStep(targets, op.matrix))
            continue

        qubits = op.controls + op.targets
        gis = {group_of[q] for q in qubits}
        if op.matrix is not None:
            if len(gis) > 1:
                dec = (decompose_spanning_swap(op)
                       or eigen_decompose_controlled(op))
                if dec is not None:
                    queue.extendleft(reversed(dec))
                    continue
            mat = controlled(op.matrix, len(op.controls)) if op.controls \
                else op.matrix
            if len(gis) == 1:
                gi = next(iter(gis))
                fold(gi, qubits, Term(local(gi, qubits), mat))
            else:
                flush_overlapping(qubits)
                plan.steps.append(ContractStep(qubits, mat))
        else:
            if len(gis) == 1:
                gi = next(iter(gis))
                fold(gi, qubits, Term(local(gi, qubits), None,
                                      op.param_idx, op.maker,
                                      len(op.controls)))
            else:
                flush_overlapping(qubits)
                plan.steps.append(ContractStep(qubits, None, op.param_idx,
                                               op.maker, len(op.controls)))

    for gi in sorted(pending):
        flush(gi)
    plan.steps = merge_adjacent_diags(plan.steps)
    plan.steps = _detect_reflections(plan.steps, n)
    plan.steps = _fuse_phases(plan.steps)
    plan.steps = _fuse_flips(plan.steps)
    if pair:
        plan.steps = _pair_windows(plan.steps, n)
    return plan


def _detect_reflections(steps: list[Step], n: int) -> list[Step]:
    """Replace ``windows_A · flip(idx) · windows_B`` with a ReflectStep when
    B is the blockwise inverse of A (``qbot_tpu/tpu/compiler.py:752-817``).

    Windows on disjoint qubits commute, so matching is by (start, width)
    regardless of order within each run.
    """
    out: list[Step] = list(steps)
    i = 0
    while i < len(out):
        step = out[i]
        if not isinstance(step, FlipStep):
            i += 1
            continue
        a_lo = i
        while a_lo > 0 and isinstance(out[a_lo - 1], WindowStep):
            a_lo -= 1
        b_hi = i + 1
        while b_hi < len(out) and isinstance(out[b_hi], WindowStep):
            b_hi += 1
        a_run = out[a_lo:i]
        b_run = out[i + 1:b_hi]
        if not a_run or not b_run:
            i += 1
            continue
        a_by = {(w.start, w.width): w for w in a_run}
        b_by = {(w.start, w.width): w for w in b_run}
        if len(a_by) != len(a_run) or set(a_by) != set(b_by):
            i += 1
            continue
        mats = {}
        for key, wa in a_by.items():
            ma = fold_window_static(wa)
            mb = fold_window_static(b_by[key])
            if ma is None or mb is None or not np.allclose(
                    mb, ma.conj().T, atol=1e-9):
                break
            mats[key] = ma
        else:
            # v = A† |idx⟩, a product over blocks tiling [0, n): a window
            # block gives the conjugate of row idx_w of A_w, a gap block a
            # basis vector
            idx = step.index
            factors: list[np.ndarray] = []
            q = 0
            for start, width in sorted(a_by) + [(n, 0)]:
                if q < start:
                    gap = start - q
                    bits = (idx >> (n - start)) & ((1 << gap) - 1)
                    e = np.zeros(2**gap, np.complex128)
                    e[bits] = 1.0
                    factors.append(e)
                if width:
                    w_idx = (idx >> (n - start - width)) & ((1 << width) - 1)
                    factors.append(np.conj(mats[(start, width)][w_idx, :]))
                q = start + width
            out[a_lo:b_hi] = [ReflectStep(tuple(factors),
                                          tuple(out[a_lo:b_hi]))]
            i = a_lo + 1
            continue
        i += 1
    return out

"""Plain density-matrix reference: the request's product initial state
ρ0 = ρ_0 ⊗ … ⊗ ρ_{n−1} (qubit 0 the most significant bit) taken through the
request's circuit gate by gate as ρ → UρU† in complex128, and the
comparison that judges the program's final ρ and readouts against it.

Each gate is its full matrix under its controls (the identity but for the
last block, the controls' axes first), contracted over the gate's axes of
the row index and, conjugated, over the same axes of the column index: two
contractions over a view of ρ as a state of 2n qubits, the row index
qubits [0, n) and the column index [n, 2n), each a sum over the matrix's
entries of a scalar times a slice of ρ.  No plan, window, fusion or
batching: every gate is its own two contractions, in the request's order.
A flip ("flip", m) negates row m and column m.  ρ is one tensor of 4^n
entries (1 GiB at 13 qubits), which the card holds whole.

It imports nothing of the program and takes nothing the program made: only
the request's factors ``rhos`` and ops.  In complex64 every product reads
operands rounded to TF32, with float32 sums: the control, the reference in
the program's place one precision below the configuration's float32.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.statevector import _no_tf32, tf32, worst


def _operand(x: torch.Tensor, low: bool) -> torch.Tensor:
    return tf32(x) if low else x


def _tensor(m, dtype, device="cpu") -> torch.Tensor:
    t = torch.from_numpy(np.asarray(m, np.complex128)).to(device, dtype)
    return _operand(t, dtype == torch.complex64)


def initial_density(request, device, dtype=torch.complex128) -> torch.Tensor:
    """ρ0, the Kronecker product of the request's 2 × 2 factors, (2^n, 2^n)."""
    rho = torch.ones((1, 1), dtype=dtype, device=device)
    for r in request.rhos:
        rho = torch.kron(_operand(rho, dtype == torch.complex64),
                         _tensor(r, dtype, device))
    return rho


def full_matrix(matrix, controls) -> np.ndarray:
    """The gate's matrix over its controls' and targets' axes, in that
    order: the identity but for the block where every control is 1."""
    m = np.asarray(matrix, np.complex128)
    full = np.eye(2 ** len(controls) * m.shape[0], dtype=np.complex128)
    full[-m.shape[0]:, -m.shape[0]:] = m
    return full


def contract(x: torch.Tensor, n2: int, axes, m: torch.Tensor) -> torch.Tensor:
    """The 2^k × 2^k matrix ``m`` (on the host) applied to the qubits
    ``axes`` (in m's order) of the flat 2^n2 tensor ``x``, as on a ket;
    returns a new flat tensor.  On consecutive ascending axes, over a
    (A, d, B) view, each output slice i is Σ_j m[i, j]·x[:, j, :] summed
    elementwise in j's order; on other axes the axes are moved together
    for one matrix product."""
    k, d = len(axes), m.shape[0]
    x = _operand(x, x.dtype == torch.complex64)
    lo = axes[0]
    if list(axes) == list(range(lo, lo + k)):
        x3 = x.view(2 ** lo, d, 2 ** (n2 - lo - k))
        out = torch.empty_like(x3)
        for i in range(d):
            o = out[:, i, :]
            torch.mul(x3[:, 0, :], complex(m[i, 0]), out=o)
            for j in range(1, d):
                o.add_(x3[:, j, :], alpha=complex(m[i, j]))
        return out.view(-1)
    shape, at = [], {}
    pos = 0
    for q in sorted(axes):              # each axis its own, the runs merged
        if q > pos:
            shape.append(2 ** (q - pos))
        at[q] = len(shape)
        shape.append(2)
        pos = q + 1
    shape.append(2 ** (n2 - pos))
    where = [at[q] for q in axes]
    moved = x.view(shape).movedim(where, list(range(k)))
    out = (m.to(x.device) @ moved.reshape(d, -1)).view(moved.shape)
    return out.movedim(list(range(k)), where).reshape(-1)


def apply_ops(rho: torch.Tensor, n: int, ops) -> torch.Tensor:
    """``ops`` applied in order to ``rho`` (2^n, 2^n): U on the rows, then
    conj(U) on the columns; returns the result."""
    x = rho.reshape(-1)
    for op in ops:
        if op[0] == "flip":
            r = x.view(2 ** n, 2 ** n).clone()
            r[op[1], :] = -r[op[1], :]
            r[:, op[1]] = -r[:, op[1]]
            x = r.reshape(-1)
            continue
        _, targets, matrix, controls = op
        full = full_matrix(matrix, controls)
        axes = [*controls, *targets]
        x = contract(x, 2 * n, axes, _tensor(full, x.dtype))
        x = contract(x, 2 * n, [n + q for q in axes],
                     _tensor(full.conj(), x.dtype))
    return x.view(2 ** n, 2 ** n)


def simulate(request, device, dtype=torch.complex128) -> torch.Tensor:
    """The request's final ρ: init ops once, then the body ``repeats``
    times, from ρ0; in complex64, every product in TF32 (the control)."""
    _no_tf32()
    n = request.n
    rho = apply_ops(initial_density(request, device, dtype), n,
                    request.init_ops)
    for _ in range(request.repeats):
        rho = apply_ops(rho, n, request.body_ops)
    return rho


def _complex(planar: torch.Tensor, device) -> torch.Tensor:
    planar = planar.to(device)
    return torch.complex(planar[0].double(), planar[1].double())


def control_outputs(request, device, seed: int) -> dict:
    """The control in the program's place: the outputs :func:`judge`
    reads, from :func:`simulate` in TF32."""
    rho = simulate(request, device, torch.complex64)
    state = torch.stack([rho.real, rho.imag]).float()
    return {"state": state,
            "readouts": [torch.diagonal(rho).real.float().cpu()]}


def _frobenius(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x))


def judge(request, outputs: dict, device) -> dict:
    """Readings of the program's outputs against the reference.

    ``outputs``: ``state``, the planar (2, 2^n, 2^n) float32 final ρ of a
    run, and ``readouts``, the (2^n,) diagonals of the runs judged.
    ``state_gap``: the relative Frobenius distance of ρ from the
    reference's; ``probs_gap``: the largest distance of a readout's entry
    from the reference's diagonal, over its largest entry; ``trace_gap``:
    |Tr ρ − 1|; ``hermitian_gap``: ‖ρ − ρ†‖_F / ‖ρ‖_F, which a column side
    run with the wrong matrix, or not at all, moves."""
    ref = simulate(request, device)
    got = _complex(outputs["state"], device)
    state_gap = _frobenius(got - ref) / _frobenius(ref)
    p_ref = torch.diagonal(ref).real.clone()
    del ref
    top = float(torch.max(p_ref))
    probs_gap = 0.0
    for probs in outputs["readouts"]:
        gap = torch.max(torch.abs(probs.to(device).double() - p_ref))
        probs_gap = worst(probs_gap, float(gap) / top)
    trace_gap = abs(complex(torch.sum(torch.diagonal(got))) - 1.0)
    hermitian_gap = _frobenius(got - got.mH) / _frobenius(got)
    return {"state_gap": state_gap, "probs_gap": probs_gap,
            "trace_gap": trace_gap, "hermitian_gap": hermitian_gap}

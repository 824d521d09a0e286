"""Plain statevector reference: the request's circuit applied gate by gate
to |0…0⟩ in complex128, a state of shape (2,)*n (qubit q on axis q, qubit 0
the most significant bit), and the comparison that judges the program's
final state and readouts against it.

It imports nothing of the program and takes nothing the program made:
only the request's ops.  Runs of 1-qubit gates on distinct qubits are
applied together, up to six neighbouring qubits a product of their
Kronecker matrix (identities filling the qubits without a gate), which is
the same product taken in fewer passes; a controlled gate acts on the
slice where its controls are 1.

In complex64 every product reads operands rounded to TF32, with float32
sums: the control, the reference in the program's place one precision
below the configuration's float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

GROUP = 6                  # qubits of one Kronecker product


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def zero_state(n: int, device, dtype=torch.complex128) -> torch.Tensor:
    psi = torch.zeros((2,) * n, dtype=dtype, device=device)
    psi[(0,) * n] = 1.0
    return psi


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (complex64) with the real and imaginary parts rounded to
    TF32's 10-bit significand, to nearest even: the operands a TF32
    product reads."""
    bits = torch.view_as_real(x).contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return torch.view_as_complex(bits.view(torch.float32))


def _operand(x: torch.Tensor, low: bool) -> torch.Tensor:
    return tf32(x) if low else x


def _apply_group(psi: torch.Tensor, start: int, mats: list) -> torch.Tensor:
    """The Kronecker product of ``mats`` on qubits ``start`` on, as one
    matrix product over a (2^a, 2^g, 2^b) view of the state."""
    n = psi.dim()
    k = np.array([[1.0]], dtype=np.complex128)
    for m in mats:
        k = np.kron(k, m)
    low = psi.dtype == torch.complex64
    k = _operand(torch.from_numpy(k).to(psi.device, psi.dtype), low)
    psi = _operand(psi, low)
    g = len(mats)
    a, b = 2 ** start, 2 ** (n - start - g)
    if b == 1:
        out = psi.reshape(a, 2 ** g) @ k.T
    else:
        out = torch.matmul(k, psi.reshape(a, 2 ** g, b))
    return out.reshape(psi.shape)


def _flush(psi: torch.Tensor, pending: dict) -> torch.Tensor:
    """The pending 1-qubit gates, in Kronecker groups of up to GROUP
    neighbouring qubits aligned from the last qubit down."""
    eye = np.eye(2, dtype=np.complex128)
    qubits = sorted(pending)
    while qubits:
        last = qubits[-1]
        start = max(0, last - GROUP + 1)
        mats = [pending.get(q, eye) for q in range(start, last + 1)]
        psi = _apply_group(psi, start, mats)
        qubits = [q for q in qubits if q < start]
    pending.clear()
    return psi


def _apply_controlled(psi: torch.Tensor, matrix, targets, controls):
    """A gate on ``targets`` where every control is 1, in place: one target
    as two elementwise sums over the slice's halves, more by a matrix
    product over the permuted slice."""
    n = psi.dim()
    low = psi.dtype == torch.complex64
    m = np.asarray(matrix, np.complex128)
    if low:
        m = tf32(torch.from_numpy(m.astype(np.complex64))).numpy()
    if len(targets) == 1:
        idx = [slice(None)] * n
        for c in controls:
            idx[c] = 1
        sub = psi[tuple(idx)]
        t = targets[0] - sum(c < targets[0] for c in controls)
        a0, a1 = sub.select(t, 0), sub.select(t, 1)
        b0, b1 = _operand(a0, low), _operand(a1, low)
        n0 = b0 * complex(m[0, 0]) + b1 * complex(m[0, 1])
        n1 = b0 * complex(m[1, 0]) + b1 * complex(m[1, 1])
        a0.copy_(n0)
        a1.copy_(n1)
        return psi
    rest = [a for a in range(n) if a not in targets and a not in controls]
    v = psi.permute(list(controls) + list(targets) + rest)
    sub = v[(1,) * len(controls)]
    flat = sub.reshape(2 ** len(targets), -1)
    mat = torch.from_numpy(m).to(psi.device, psi.dtype)
    sub.copy_((mat @ _operand(flat, low)).reshape(sub.shape))
    return psi


def apply_ops(psi: torch.Tensor, ops) -> torch.Tensor:
    """``ops`` applied in order to ``psi`` (which may be changed in place);
    returns the result."""
    pending: dict = {}
    for op in ops:
        if op[0] == "flip":
            psi = _flush(psi, pending)
            flat = psi.reshape(-1)
            flat[op[1]] = -flat[op[1]]
            continue
        _, targets, matrix, controls = op
        if len(targets) == 1 and not controls:
            q = targets[0]
            pending[q] = (np.asarray(matrix, np.complex128)
                          @ pending.get(q, np.eye(2, dtype=np.complex128)))
            continue
        if pending.keys() & set(targets) | pending.keys() & set(controls):
            psi = _flush(psi, pending)
        psi = _apply_controlled(psi, matrix, targets, controls)
    return _flush(psi, pending)


def simulate(request, device, dtype=torch.complex128) -> torch.Tensor:
    """The request's final state: init ops once, then the body
    ``repeats`` times; in complex64, every product in TF32 (the control)."""
    _no_tf32()
    psi = apply_ops(zero_state(request.n, device, dtype), request.init_ops)
    for _ in range(request.repeats):
        psi = apply_ops(psi, request.body_ops)
    return psi


def worst(a: float, b: float) -> float:
    """The larger of two readings, NaN if either is."""
    return a + b if math.isnan(a) or math.isnan(b) else max(a, b)


def _complex(planar: torch.Tensor, device) -> torch.Tensor:
    planar = planar.to(device)
    return torch.complex(planar[0].double(), planar[1].double())


def control_outputs(request, device, seed: int) -> dict:
    """The control in the program's place: the outputs :func:`judge`
    reads, from :func:`simulate` in TF32."""
    psi = simulate(request, device, torch.complex64).reshape(-1)
    state = torch.stack([psi.real, psi.imag]).float()
    return {"state": state,
            "readouts": [(psi.real ** 2 + psi.imag ** 2).float().cpu()]}


def judge(request, outputs: dict, device) -> dict:
    """Readings of the program's outputs against the reference.

    ``outputs``: ``state``, the planar (2, 2^n) float32 final state of a
    run, and ``readouts``, the (2^n,) outcome probabilities of the runs
    judged.  ``state_gap``: the relative L2 distance of the state from the
    reference's; ``probs_gap``: the largest distance of a readout's
    probability from the reference's, over the largest reference
    probability."""
    ref = simulate(request, device).reshape(-1)
    got = _complex(outputs["state"], device)
    state_gap = float(torch.linalg.vector_norm(got - ref)
                      / torch.linalg.vector_norm(ref))
    del got
    p_ref = ref.real ** 2 + ref.imag ** 2
    del ref
    top = float(torch.max(p_ref))
    probs_gap = 0.0
    for probs in outputs["readouts"]:
        gap = torch.max(torch.abs(probs.to(device).double() - p_ref))
        probs_gap = worst(probs_gap, float(gap) / top)
    return {"state_gap": state_gap, "probs_gap": probs_gap}

"""The complex statevector and density-matrix executors of compiled plans.

Port of :mod:`qbot_tpu.tpu.simulator`, in PyTorch's complex dtypes
(``complex64`` by default, ``complex128``) on any device: plain tensor
code, as the reference's is XLA, and the dense oracle the planar executor
and its gradients are held against.  A statevector is a flat ``(2^n,)``
complex tensor, a density matrix ``(2^n, 2^n)``.

* each :class:`WindowStep` folds its terms into one 2^w × 2^w unitary
  (:func:`fold_window`; a parameterised term calls its maker on
  ``params``, so the result is differentiable in the angles) and applies
  it as one batched product;
* a :class:`DiagStep` is one elementwise multiply, a :class:`FlipStep` one
  sign, a :class:`ContractStep` one contraction over its targets, a
  :class:`ReflectStep` ψ → Fψ − 2⟨v|Fψ⟩v through its product factors;
* pairs and fused phases run as their windows and diagonal steps
  (``expand_pairs``, ``expand_phases``).

Tensors are viewed with one size-2 axis per touched qubit and the runs of
other qubits merged (``planar._grouped_view``), never as ``(2,)*n``, so
the executors stay within PyTorch's dimension limit at any n.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from qbot_tpu_torch.tpu.compiler import (
    DiagStep,
    FlipStep,
    Plan,
    ReflectStep,
    Term,
    WindowStep,
    expand_pairs,
    expand_phases,
    expand_reflections,
)
from qbot_tpu_torch.tpu.kernels import _fp32_matmul
from qbot_tpu_torch.tpu.planar import (
    _as_params,
    _grouped_view,
    _marginal,
    reflect_component,
)

__all__ = ["zero_state", "fold_window", "apply_plan", "apply_plan_density",
           "make_statevector_runner", "make_density_runner",
           "make_scanned_runner", "computation_probs", "expectation_z"]

DTYPE = torch.complex64


def zero_state(n: int, dtype=DTYPE, device="cuda") -> torch.Tensor:
    """|0…0⟩ on ``device``: the card unless the caller asks for another."""
    psi = torch.zeros(2**n, dtype=dtype, device=device)
    psi[0] = 1.0
    return psi


def _controlled(mat: torch.Tensor, num_controls: int) -> torch.Tensor:
    """``mat`` under ``num_controls`` leading controls."""
    size = mat.shape[0]
    eye = torch.eye(2**num_controls * size - size, dtype=mat.dtype,
                    device=mat.device)
    return torch.block_diag(eye, mat)


def _maker_matrix(maker, theta, num_controls: int, dtype, device):
    """A parameterised gate's complex matrix: its maker's planar (2, d, d)
    output (or a complex (d, d) one) at ``theta``, under its controls."""
    mat = maker(theta)
    if mat.dim() == 3:
        mat = torch.complex(mat[0], mat[1])
    mat = mat.to(dtype=dtype, device=device)
    if num_controls:
        mat = _controlled(mat, num_controls)
    return mat


def _term_matrix(term: Term, params, dtype, device) -> torch.Tensor:
    if term.matrix is not None:
        return torch.as_tensor(np.asarray(term.matrix), device=device
                               ).to(dtype)
    if params is None:
        raise ValueError("the plan has parameterised gates: pass params")
    return _maker_matrix(term.maker, params[term.param_idx],
                         term.num_controls, dtype, device)


def fold_window(step: WindowStep, params, dtype=DTYPE,
                device=None) -> torch.Tensor:
    """Fold all of a window's terms into one 2^w × 2^w unitary, in
    ``dtype`` on ``device`` (default the angles' device, else the card);
    differentiable in ``params``."""
    if device is None:
        device = params.device if isinstance(params, torch.Tensor) else "cuda"
    w, dim = step.width, 2**step.width
    # W viewed as (2,)*w row axes ⊗ flattened column axis; each term is
    # contracted over its window-relative row axes
    W = torch.eye(dim, dtype=dtype, device=device).reshape((2,) * w + (dim,))
    for term in step.terms:
        m = _term_matrix(term, params, dtype, device)
        k = len(term.positions)
        g = m.reshape((2,) * (2 * k))
        W = torch.tensordot(g, W, dims=(list(range(k, 2 * k)),
                                        list(term.positions)))
        W = torch.movedim(W, list(range(k)), list(term.positions))
    return W.reshape(dim, dim)


# ---------------------------------------------------------------------------
# step application on a flat vector of m qubits (a statevector, or a
# density matrix as a 2n-qubit vector: rows qubits [0, n), columns [n, 2n))
# ---------------------------------------------------------------------------

def _flip(flat: torch.Tensor, indices) -> torch.Tensor:
    if not indices:
        return flat
    out = flat.clone()
    for m in indices:
        out[m] = -out[m]
    return out


def _window(flat: torch.Tensor, start: int, W: torch.Tensor) -> torch.Tensor:
    t = flat.reshape(2**start, W.shape[0], -1)
    with _fp32_matmul():
        return torch.einsum("ij,ajb->aib", W, t).reshape(flat.shape)


def _diag(flat: torch.Tensor, m: int, targets, diag) -> torch.Tensor:
    """Multiply by the diagonal ``diag`` on ``targets`` (its index
    big-endian over ``targets`` in their given order)."""
    k = len(targets)
    shape, axes, _ = _grouped_view(m, targets)
    d = np.asarray(diag, np.complex128).reshape((2,) * k)
    d = np.transpose(d, np.argsort(axes))          # -> qubit order
    bshape = [2 if i in axes else 1 for i in range(len(shape))]
    dt = torch.as_tensor(d.reshape(bshape), device=flat.device).to(
        flat.dtype)
    return (flat.reshape(shape) * dt).reshape(flat.shape)


def _contract(flat: torch.Tensor, m: int, targets,
              mat: torch.Tensor) -> torch.Tensor:
    """The k-qubit gate ``mat`` on ``targets`` as one contraction."""
    k = len(targets)
    shape, axes, _ = _grouped_view(m, targets)
    g = mat.reshape((2,) * (2 * k))
    with _fp32_matmul():
        t = torch.tensordot(g, flat.reshape(shape),
                            dims=(list(range(k, 2 * k)), axes))
    return torch.movedim(t, list(range(k)), axes).reshape(flat.shape)


def _contract_matrix(step, params, dtype, device) -> torch.Tensor:
    if step.matrix is not None:
        return torch.as_tensor(np.asarray(step.matrix), device=device
                               ).to(dtype)
    if params is None:
        raise ValueError("the plan has parameterised gates: pass params")
    return _maker_matrix(step.maker, params[step.param_idx],
                         step.num_controls, dtype, device)


def _apply_reflect(psi: torch.Tensor, step: ReflectStep) -> torch.Tensor:
    """ψ → Fψ − 2⟨v|Fψ⟩v for the product |v⟩ = ⊗ factors; the fused flips
    F as O(1) corrections of c and of the output."""
    dims = tuple(f.shape[0] for f in step.factors)
    factors = [torch.as_tensor(np.asarray(f, np.complex128),
                               device=psi.device).to(psi.dtype)
               for f in step.factors]
    t = psi.reshape(dims)
    c = t
    for f in factors:
        c = torch.tensordot(torch.conj(f), c, dims=([0], [0]))
    flip_vals = []
    for m in step.pre_flips:
        vm = reflect_component(step.factors, m)
        pm = psi[m]
        c = c - 2.0 * complex(np.conj(vm)) * pm
        flip_vals.append((m, pm))
    v = torch.ones((), dtype=psi.dtype, device=psi.device)
    for ax, f in enumerate(factors):
        shape = [1] * len(dims)
        shape[ax] = dims[ax]
        v = v * f.reshape(shape)
    out = (t - 2.0 * c * v).reshape(-1)
    if flip_vals:
        out = out.clone()
        for m, pm in flip_vals:
            out[m] = out[m] - 2.0 * pm
    return out.reshape(psi.shape)


def apply_plan(psi: torch.Tensor, plan: Plan, params=None) -> torch.Tensor:
    """Run a compiled plan over a flat complex statevector; differentiable
    in ``psi`` and ``params``."""
    n = plan.n
    params = _as_params(params, psi.device)
    for step in expand_pairs(expand_phases(plan.steps)):
        if isinstance(step, WindowStep):
            psi = _flip(psi, step.pre_flips)
            W = fold_window(step, params, psi.dtype, psi.device)
            psi = _window(psi, step.start, W)
        elif isinstance(step, ReflectStep):
            psi = _apply_reflect(psi, step)
        elif isinstance(step, DiagStep):
            psi = _diag(psi, n, step.targets, step.diag)
        elif isinstance(step, FlipStep):
            psi = _flip(psi, (step.index,))
        else:
            psi = _contract(psi, n, step.targets, _contract_matrix(
                step, params, psi.dtype, psi.device))
    return psi


def _density_flips(flat: torch.Tensor, n: int, indices) -> torch.Tensor:
    """ρ → FρF: each flipped basis state negates its row and column."""
    if not indices:
        return flat
    d = 2**n
    rho = flat.reshape(d, d).clone()
    for m in indices:
        rho[m, :] = -rho[m, :]
        rho[:, m] = -rho[:, m]
    return rho.reshape(-1)


def apply_plan_density(rho: torch.Tensor, plan: Plan,
                       params=None) -> torch.Tensor:
    """Run a compiled plan over a (2^n, 2^n) complex density matrix:
    ρ → U ρ U† step by step (rows at q, conjugated columns at n + q)."""
    n = plan.n
    params = _as_params(params, rho.device)
    flat = rho.reshape(-1)
    for step in expand_pairs(expand_phases(expand_reflections(plan.steps))):
        if isinstance(step, WindowStep):
            flat = _density_flips(flat, n, step.pre_flips)
            W = fold_window(step, params, rho.dtype, rho.device)
            flat = _window(flat, step.start, W)
            flat = _window(flat, n + step.start, torch.conj(W))
        elif isinstance(step, FlipStep):
            flat = _density_flips(flat, n, (step.index,))
        elif isinstance(step, DiagStep):
            flat = _diag(flat, 2 * n, step.targets, step.diag)
            flat = _diag(flat, 2 * n, tuple(n + q for q in step.targets),
                         np.conj(np.asarray(step.diag)))
        else:
            m = _contract_matrix(step, params, rho.dtype, rho.device)
            flat = _contract(flat, 2 * n, step.targets, m)
            flat = _contract(flat, 2 * n,
                             tuple(n + q for q in step.targets),
                             torch.conj(m))
    d = 2**n
    return flat.reshape(d, d)


# ---------------------------------------------------------------------------
# runner factories (PyTorch runs eagerly: each returns the executor bound to
# its plan)
# ---------------------------------------------------------------------------

def make_statevector_runner(plan: Plan):
    """``run(psi, params=None) -> psi`` for one plan."""
    def run(psi, params=None):
        return apply_plan(psi, plan, params)
    return run


def make_density_runner(plan: Plan):
    """``run(rho, params=None) -> rho`` for one plan."""
    def run(rho, params=None):
        return apply_plan_density(rho, plan, params)
    return run


def make_scanned_runner(body_plan: Plan, repeats: int,
                        init_plan: Optional[Plan] = None):
    """``run(psi, params=None)`` applying ``init_plan`` once, then
    ``body_plan`` ``repeats`` times (the reference's ``lax.scan``)."""
    def run(psi, params=None):
        if init_plan is not None:
            psi = apply_plan(psi, init_plan, params)
        for _ in range(repeats):
            psi = apply_plan(psi, body_plan, params)
        return psi
    return run


# ---------------------------------------------------------------------------
# readout
# ---------------------------------------------------------------------------

def _qubits(psi: torch.Tensor, n: Optional[int]) -> int:
    if n is not None:
        return n
    return (psi.shape[-1].bit_length() - 1 if psi.dim() == 1
            else psi.dim())


def computation_probs(psi: torch.Tensor, targets=None,
                      n: Optional[int] = None) -> torch.Tensor:
    """Marginal computation-basis outcome probabilities of ``targets``
    (sorted qubit order), or of the whole register."""
    n = _qubits(psi, n)
    flat = psi.reshape(-1)
    return _marginal(flat.real ** 2 + flat.imag ** 2, targets, n)


def expectation_z(psi: torch.Tensor, qubit: int,
                  n: Optional[int] = None) -> torch.Tensor:
    """⟨Z_q⟩ of a statevector."""
    marg = computation_probs(psi, [qubit], _qubits(psi, n))
    return marg[0] - marg[1]

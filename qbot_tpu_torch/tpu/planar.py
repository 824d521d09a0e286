"""Planar statevector and density-matrix executors on PyTorch.

Port of :mod:`qbot_tpu.tpu.planar`.  A state is a float32 tensor of shape
``(2, 2^n)`` holding (real, imag) planes, a density matrix one of shape
``(2, 2^n, 2^n)``, on any device; every entry point takes or returns
tensors on the caller's device.  Window, pair and reflection steps go
through the kernels of :mod:`qbot_tpu_torch.tpu.kernels`; diagonal, phase,
flip and contraction steps are plain PyTorch, as they are XLA outside
Pallas in the JAX package.  Every step is out of place: the caller's state
is never written.

Not ported yet: parameterised gates and ``renorm_every`` (they raise
``NotImplementedError`` naming the ROADMAP item that brings them), the
precision modes (every product is full float32), and the dot engine
(``plan.engine``, which the port's compiler never sets, is not read: every
plan runs on the window and pair kernels).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from qbot_tpu.tpu.compiler import (
    ContractStep,
    DiagStep,
    FlipStep,
    PairStep,
    PhaseStep,
    Plan,
    ReflectStep,
    WindowStep,
    expand_phases,
    expand_reflections,
    phase_as_diag,
)
from qbot_tpu_torch.tpu import kernels
from qbot_tpu_torch.tpu.kernels import _fp32_matmul

__all__ = ["zero_state_planar", "to_planar", "from_planar",
           "product_state_planar", "fold_window_static",
           "apply_plan_planar", "apply_plan_planar_ref",
           "make_scanned_planar_runner", "planar_probs", "planar_norm",
           "zero_density_planar", "apply_plan_density_planar",
           "apply_plan_density_planar_ref", "make_planar_density_runner",
           "planar_density_probs"]

REAL_DTYPE = torch.float32

_PARAM_TODO = ("parameterised gates are not ported yet "
               "(ROADMAP queue 1, item 8: inference and the kernels' backward)")
_RENORM_TODO = ("renorm_every is not ported yet (ROADMAP queue 1, item 5: "
                "precision modes and renormalisation)")


# ---------------------------------------------------------------------------
# states
# ---------------------------------------------------------------------------

def product_state_planar(kets, device) -> torch.Tensor:
    """Planar (2, 2^n) normalised product state ⊗kets, built on ``device``.

    Each ket goes to the device as it is (a few amplitudes, or one ket that
    lowering already materialised on the host); the Kronecker products and
    the normalisation run on the device, so no 2^n array is built on the
    host.
    """
    r = torch.ones(1, dtype=REAL_DTYPE, device=device)
    i = torch.zeros(1, dtype=REAL_DTYPE, device=device)
    for k in kets:
        k = np.asarray(k, np.complex128).ravel()
        pk = torch.from_numpy(to_planar(k)).to(device)
        br, bi = pk[0], pk[1]
        r, i = ((r[:, None] * br[None, :] - i[:, None] * bi[None, :])
                .reshape(-1),
                (r[:, None] * bi[None, :] + i[:, None] * br[None, :])
                .reshape(-1))
    nrm = torch.sqrt(torch.sum(r * r + i * i))
    return torch.stack([r, i]) / nrm


def zero_state_planar(n: int, device) -> torch.Tensor:
    psi = torch.zeros((2, 2**n), dtype=REAL_DTYPE, device=device)
    psi[0, 0] = 1.0
    return psi


def to_planar(psi_complex: np.ndarray, dtype=np.float32) -> np.ndarray:
    return np.stack([np.real(psi_complex),
                     np.imag(psi_complex)]).astype(dtype)


def from_planar(psi) -> np.ndarray:
    """Complex numpy vector of a planar state (tensor or array)."""
    if isinstance(psi, torch.Tensor):
        psi = psi.detach().cpu().numpy()
    psi = np.asarray(psi)
    return psi[0] + 1j * psi[1]


def fold_window_static(step: WindowStep) -> Optional[np.ndarray]:
    """Fuse a window's terms into one complex matrix on the host.

    Returns None if any term is parameterised.
    """
    if any(t.matrix is None for t in step.terms):
        return None
    w, dim = step.width, 2**step.width
    W = np.eye(dim, dtype=np.complex128).reshape((2,) * w + (dim,))
    for term in step.terms:
        m = np.asarray(term.matrix, dtype=np.complex128)
        k = len(term.positions)
        g = m.reshape((2,) * (2 * k))
        W = np.tensordot(g, W, axes=(list(range(k, 2 * k)),
                                     list(term.positions)))
        W = np.moveaxis(W, list(range(k)), list(term.positions))
    return W.reshape(dim, dim)


def _planar_tensor(mat, device) -> torch.Tensor:
    return torch.from_numpy(to_planar(np.asarray(mat, np.complex128))
                            ).to(device)


def _grouped_view(n: int, qubits):
    """View of a 2^n axis that keeps each of ``qubits`` as its own size-2
    axis and merges the runs of other qubits between them.

    Returns (shape, axis of each qubit in ``qubits`` order, axes of the
    merged runs).  Keeps tensors far below PyTorch's dimension limits at
    any n, where a (2,)*n view would not.
    """
    shape, axis_of, rest = [], {}, []
    pos = 0
    for q in sorted(qubits):
        if q > pos:
            rest.append(len(shape))
            shape.append(2 ** (q - pos))
        axis_of[q] = len(shape)
        shape.append(2)
        pos = q + 1
    if pos < n:
        rest.append(len(shape))
        shape.append(2 ** (n - pos))
    return shape, [axis_of[q] for q in qubits], rest


# ---------------------------------------------------------------------------
# steps: each prepares its device tables once and returns psi -> psi
# ---------------------------------------------------------------------------

class _Ops(NamedTuple):
    window: Callable
    pair: Callable
    reflect_dot: Callable
    reflect_update: Callable


_KERNELS = _Ops(kernels.window_apply, kernels.pair_apply,
                kernels.reflect_dot, kernels.reflect_update)
_PLAIN = _Ops(kernels.window_apply_ref, kernels.pair_apply_ref,
              kernels.reflect_dot_ref, kernels.reflect_update_ref)


def _window_matrix(step: WindowStep) -> np.ndarray:
    static = fold_window_static(step)
    if static is None:
        raise NotImplementedError(_PARAM_TODO)
    return static


def _window_fn(n: int, step: WindowStep, device, ops: _Ops):
    w = _planar_tensor(_window_matrix(step), device)
    diag = kernels.fused_diagonals(n, step.pre_flips, step.pre_phases,
                                   device)
    return lambda psi: ops.window(psi, n, step.start, step.width, w, diag)


def _pair_parts(step: PairStep):
    """(start, width1, width2, W1, W2) of a pair of adjacent windows."""
    first, second = step.first, step.second
    if first.start + first.width != second.start:
        raise ValueError("pair windows must be qubit-contiguous")
    return (first.start, first.width, second.width, _window_matrix(first),
            _window_matrix(second))


def _pair_fn(n: int, step: PairStep, device, ops: _Ops):
    """Both windows of a PairStep in one pass, after the first window's
    fused flips and phases."""
    start, width1, width2, m1, m2 = _pair_parts(step)
    w1, w2 = _planar_tensor(m1, device), _planar_tensor(m2, device)
    diag = kernels.fused_diagonals(n, step.first.pre_flips,
                                   step.first.pre_phases, device)
    return lambda psi: ops.pair(psi, n, start, width1, width2, w1, w2, diag)


def reflect_component(factors, index: int) -> complex:
    """Static component ``v[index]`` of the product state |v⟩ = ⊗ factors."""
    v = 1.0 + 0.0j
    shift = sum(int(f.shape[0]).bit_length() - 1 for f in factors)
    for f in factors:
        d = int(f.shape[0])
        shift -= d.bit_length() - 1
        v *= complex(np.asarray(f, np.complex128)[(index >> shift) & (d - 1)])
    return v


class _Reflection:
    """Device tables of a ReflectStep: |v⟩ = A ⊗ B with A the Kronecker
    product of all factors but the last (H entries) and B the last (T)."""

    def __init__(self, step: ReflectStep, device):
        head = np.ones(1, np.complex128)
        for f in step.factors[:-1]:
            head = np.kron(head, np.asarray(f, np.complex128))
        tail = np.asarray(step.factors[-1], np.complex128)
        self.H, self.T = head.shape[0], tail.shape[0]
        a32, b32 = to_planar(head), to_planar(tail)
        self.a = torch.from_numpy(a32).to(device).reshape(2, self.H, 1)
        self.b = torch.from_numpy(b32).to(device).reshape(2, 1, self.T)
        # c is scaled by 1/⟨v|v⟩ of the float32 tables: the update is then
        # the exact Householder reflection about the tables' own direction,
        # which keeps the norm however the tables round (by estimate, their
        # rounding alone would drift it by ~7e-5 over 512 Grover
        # iterations at 26 qubits)
        inv_vv = 1.0 / (float(np.sum(a32.astype(np.float64) ** 2))
                        * float(np.sum(b32.astype(np.float64) ** 2)))
        # c = Σ_t conj(B_t)·D[t] as one contraction of the planar lane dot:
        # c[i] = Σ_{j,t} lane[i, j, t]·D[j, t]
        br, bi = b32.astype(np.float64)
        lane = np.stack([np.stack([br, bi]), np.stack([-bi, br])])
        # each fused flip m shifts c by −2·conj(v_m)·ψ_m (planar.py:304-312):
        # c[i] += Σ_{j,f} flip[i, j, f]·ψ[j, m_f]
        v = np.array([reflect_component(step.factors, m)
                      for m in step.pre_flips], np.complex128)
        flip = -2.0 * np.stack([np.stack([v.real, v.imag]),
                                np.stack([-v.imag, v.real])])
        self.lane = torch.from_numpy(lane * inv_vv).to(device)
        self.flip = torch.from_numpy(
            flip.reshape(2, 2, -1) * inv_vv).to(device)
        self.flips = torch.tensor(list(step.pre_flips), dtype=torch.int64,
                                  device=device)

    def c_from_lane_dot(self, d, psi3):
        """⟨v|Fψ⟩/⟨v|v⟩ from the float64 lane dot D of ψ and the fused
        flips' values in ψ, in float64 on the device, as the (2,) float32
        tensor the update kernel reads."""
        c = torch.einsum("ijt,jt->i", self.lane, d[:, 0])
        if self.flips.numel():
            vals = psi3.reshape(2, -1)[:, self.flips].double()
            c = c + torch.einsum("ijf,jf->i", self.flip, vals)
        return c.float()


def _reflect_fn(step: ReflectStep, device, ops: _Ops):
    """ψ → Fψ − 2⟨v|Fψ⟩v: one read pass (dot) and one read+write pass."""
    refl = _Reflection(step, device)

    def apply(psi):
        p3 = psi.reshape(2, refl.H, refl.T)
        c = refl.c_from_lane_dot(ops.reflect_dot(p3, refl.a, refl.b), p3)
        out, _ = ops.reflect_update(p3, c, refl.a, refl.b, refl.flips)
        return out.reshape(psi.shape)
    return apply


def _diag_fn(n: int, targets, diag, device):
    """Elementwise pass multiplying by a diagonal on ``targets``."""
    k = len(targets)
    shape, axes, _ = _grouped_view(n, targets)
    d = np.asarray(diag, np.complex128).reshape((2,) * k)
    # diag axes in target order -> the view's axes, in qubit order
    d = np.transpose(d, np.argsort(axes))
    bshape = [2 if i in axes else 1 for i in range(len(shape))]
    dt = _planar_tensor(d, device).reshape([2] + bshape)
    dr, di = dt[0], dt[1]

    def apply(psi):
        t = psi.reshape([2] + shape)
        pr, pi = t[0], t[1]
        return torch.stack([dr * pr - di * pi,
                            dr * pi + di * pr]).reshape(psi.shape)
    return apply


def _flip_fn(index: int):
    def apply(psi):
        out = psi.clone()
        out[:, index] = -out[:, index]
        return out
    return apply


def _contract_fn(n: int, step: ContractStep, device):
    """Cross-window gate as a tensor contraction over its target axes."""
    if step.matrix is None:
        raise NotImplementedError(_PARAM_TODO)
    g = _planar_tensor(step.matrix, device)
    k = len(step.targets)
    shape, axes, _ = _grouped_view(n, step.targets)
    gr = g[0].reshape((2,) * (2 * k))
    gi = g[1].reshape((2,) * (2 * k))

    def con(gm, x):
        out = torch.tensordot(gm, x, dims=(list(range(k, 2 * k)), axes))
        return torch.movedim(out, list(range(k)), axes)

    def apply(psi):
        t = psi.reshape([2] + shape)
        pr, pi = t[0], t[1]
        with _fp32_matmul():
            out_r = con(gr, pr) - con(gi, pi)
            out_i = con(gr, pi) + con(gi, pr)
        return torch.stack([out_r, out_i]).reshape(psi.shape)
    return apply


def _step_fns(plan: Plan, device, ops: _Ops) -> list:
    n = plan.n
    fns = []
    for step in plan.steps:
        if isinstance(step, WindowStep):
            fns.append(_window_fn(n, step, device, ops))
        elif isinstance(step, PairStep):
            fns.append(_pair_fn(n, step, device, ops))
        elif isinstance(step, ReflectStep):
            fns.append(_reflect_fn(step, device, ops))
        elif isinstance(step, DiagStep):
            fns.append(_diag_fn(n, step.targets, step.diag, device))
        elif isinstance(step, PhaseStep):
            d = phase_as_diag(step)
            fns.append(_diag_fn(n, d.targets, d.diag, device))
        elif isinstance(step, FlipStep):
            fns.append(_flip_fn(step.index))
        else:
            fns.append(_contract_fn(n, step, device))
    return fns


def _run(psi, fns):
    for fn in fns:
        psi = fn(psi)
    return psi


def apply_plan_planar(psi: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Run a compiled plan over a planar (2, 2^n) float32 statevector.

    On a CUDA tensor every window, pair and reflection runs its CUDA
    kernel; on a CPU tensor, the kernels' plain versions.
    """
    return _run(psi, _step_fns(plan, psi.device, _KERNELS))


def apply_plan_planar_ref(psi: torch.Tensor, plan: Plan) -> torch.Tensor:
    """:func:`apply_plan_planar` through the kernels' plain PyTorch
    versions on any device: the reference a kernel run is checked
    against on the card."""
    return _run(psi, _step_fns(plan, psi.device, _PLAIN))


def make_scanned_planar_runner(body_plan: Plan, repeats: int,
                               init_plan: Optional[Plan] = None,
                               renorm_every: int = 0):
    """``run(psi)`` applying ``init_plan`` once, then ``body_plan``
    ``repeats`` times.

    A body that is one ReflectStep (Grover's oracle and diffusion) runs one
    ``reflect_dot`` prologue, then one ``reflect_update`` per iteration:
    each update also returns the lane dot of its result, from which the
    next ⟨v|Fψ⟩ is formed on the device, so the loop never waits for the
    host.  Other bodies loop over :func:`apply_plan_planar`.
    """
    if renorm_every:
        raise NotImplementedError(_RENORM_TODO)
    reflect_body = (len(body_plan.steps) == 1
                    and isinstance(body_plan.steps[0], ReflectStep))

    def run(psi: torch.Tensor) -> torch.Tensor:
        if init_plan is not None:
            psi = apply_plan_planar(psi, init_plan)
        if not reflect_body:
            fns = _step_fns(body_plan, psi.device, _KERNELS)
            for _ in range(repeats):
                psi = _run(psi, fns)
            return psi
        refl = _Reflection(body_plan.steps[0], psi.device)
        p3 = psi.reshape(2, refl.H, refl.T)
        c = refl.c_from_lane_dot(kernels.reflect_dot(p3, refl.a, refl.b), p3)
        for _ in range(repeats):
            p3, d = kernels.reflect_update(p3, c, refl.a, refl.b, refl.flips)
            c = refl.c_from_lane_dot(d, p3)
        return p3.reshape(psi.shape)
    return run


# ---------------------------------------------------------------------------
# readout
# ---------------------------------------------------------------------------

def planar_probs(psi: torch.Tensor, targets=None,
                 n: Optional[int] = None) -> torch.Tensor:
    """Outcome probabilities of ``targets`` (sorted qubit order), or of the
    whole register, as a tensor on the state's device."""
    if n is None:
        n = psi.shape[-1].bit_length() - 1
    return _marginal(psi[0] ** 2 + psi[1] ** 2, targets, n)


def _marginal(p: torch.Tensor, targets, n: int) -> torch.Tensor:
    """Marginal of the 2^n outcome probabilities ``p`` on ``targets``."""
    if targets is None:
        return p
    shape, _, rest = _grouped_view(n, targets)
    p = p.reshape(shape)
    if rest:
        p = torch.sum(p, dim=rest)
    return p.reshape(-1)


def planar_norm(psi: torch.Tensor) -> torch.Tensor:
    return torch.sum(psi[0] ** 2 + psi[1] ** 2)


# ---------------------------------------------------------------------------
# density matrices (``qbot_tpu/tpu/planar.py:521-657``)
#
# ρ is a planar (2, 2^n, 2^n) float32 tensor.  Viewed flat as a planar
# (2, 4^n) state of 2n qubits, the row index is qubits [0, n) and the column
# index qubits [n, 2n): every step acts on the rows at q and, conjugated, on
# the columns at n + q, through the same window and pair kernels, so a
# density plan costs twice the statevector plan's passes.
# ---------------------------------------------------------------------------

def zero_density_planar(n: int, device) -> torch.Tensor:
    rho = torch.zeros((2, 2**n, 2**n), dtype=REAL_DTYPE, device=device)
    rho[0, 0, 0] = 1.0
    return rho


def _density_flip_phases(n: int, flips) -> tuple:
    """Fused phases of the 2n-qubit view for ρ → FρF: each flipped basis
    state m negates row m and column m (and so leaves ρ[m, m])."""
    rows, cols = tuple(range(n)), tuple(range(n, 2 * n))
    return tuple(p for m in flips for p in ((rows, -1.0, m), (cols, -1.0, m)))


def _density_window_fn(n: int, step: WindowStep, device, ops: _Ops):
    """W at s on the rows (after the step's flips on rows and columns,
    fused into the row pass), conj(W) at n + s on the columns."""
    m = _window_matrix(step)
    w, wc = _planar_tensor(m, device), _planar_tensor(m.conj(), device)
    diag = kernels.fused_diagonals(
        2 * n, pre_phases=_density_flip_phases(n, step.pre_flips),
        device=device)
    none = kernels.fused_diagonals(2 * n, device=device)
    start, width = step.start, step.width

    def apply(flat):
        flat = ops.window(flat, 2 * n, start, width, w, diag)
        return ops.window(flat, 2 * n, n + start, width, wc, none)
    return apply


def _density_pair_fn(n: int, step: PairStep, device, ops: _Ops):
    """(W1, W2) at s on the rows, conjugated at n + s on the columns."""
    start, width1, width2, m1, m2 = _pair_parts(step)
    w1, w2 = _planar_tensor(m1, device), _planar_tensor(m2, device)
    w1c = _planar_tensor(m1.conj(), device)
    w2c = _planar_tensor(m2.conj(), device)
    diag = kernels.fused_diagonals(
        2 * n, pre_phases=_density_flip_phases(n, step.first.pre_flips),
        device=device)
    none = kernels.fused_diagonals(2 * n, device=device)

    def apply(flat):
        flat = ops.pair(flat, 2 * n, start, width1, width2, w1, w2, diag)
        return ops.pair(flat, 2 * n, n + start, width1, width2, w1c, w2c,
                        none)
    return apply


def _density_flip_fn(n: int, index: int):
    def apply(flat):
        rho = flat.reshape(2, 2**n, 2**n).clone()
        rho[:, index, :] = -rho[:, index, :]
        rho[:, :, index] = -rho[:, :, index]
        return rho.reshape(flat.shape)
    return apply


def _both_sides(row, col):
    return lambda flat: col(row(flat))


def _density_step_fns(plan: Plan, device, ops: _Ops) -> list:
    """Steps over the flat (2, 4^n) view: reflections expand to their
    windows and flips, fused phases to diagonal passes
    (``qbot_tpu/tpu/planar.py:589-628``)."""
    n = plan.n
    fns = []
    for step in expand_phases(expand_reflections(plan.steps)):
        if isinstance(step, WindowStep):
            fns.append(_density_window_fn(n, step, device, ops))
        elif isinstance(step, PairStep):
            fns.append(_density_pair_fn(n, step, device, ops))
        elif isinstance(step, DiagStep):
            cols = tuple(n + q for q in step.targets)
            fns.append(_both_sides(
                _diag_fn(2 * n, step.targets, step.diag, device),
                _diag_fn(2 * n, cols, np.conj(np.asarray(step.diag)),
                         device)))
        elif isinstance(step, FlipStep):
            fns.append(_density_flip_fn(n, step.index))
        else:
            if step.matrix is None:
                raise NotImplementedError(_PARAM_TODO)
            col = ContractStep(tuple(n + q for q in step.targets),
                               np.conj(np.asarray(step.matrix)))
            fns.append(_both_sides(_contract_fn(2 * n, step, device),
                                   _contract_fn(2 * n, col, device)))
    return fns


def _run_density(rho, fns):
    return _run(rho.reshape(2, -1), fns).reshape(rho.shape)


def apply_plan_density_planar(rho: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Run a compiled plan over a planar (2, 2^n, 2^n) float32 density
    matrix: ρ → UρU†.

    On a CUDA tensor every window and pair runs its CUDA kernel, on the
    rows and on the columns; on a CPU tensor, the kernels' plain versions.
    """
    return _run_density(rho, _density_step_fns(plan, rho.device, _KERNELS))


def apply_plan_density_planar_ref(rho: torch.Tensor,
                                  plan: Plan) -> torch.Tensor:
    """:func:`apply_plan_density_planar` through the kernels' plain
    PyTorch versions on any device: the reference a kernel run is checked
    against on the card."""
    return _run_density(rho, _density_step_fns(plan, rho.device, _PLAIN))


def make_planar_density_runner(plan: Plan):
    """``run(rho)``: :func:`apply_plan_density_planar` with the step tables
    (folded matrices, fused diagonals) prepared once per device."""
    prepared: dict = {}

    def run(rho: torch.Tensor) -> torch.Tensor:
        if rho.device not in prepared:
            prepared[rho.device] = _density_step_fns(plan, rho.device,
                                                     _KERNELS)
        return _run_density(rho, prepared[rho.device])
    return run


def planar_density_probs(rho: torch.Tensor, targets=None,
                         n: Optional[int] = None) -> torch.Tensor:
    """Computation-basis outcome probabilities, the diagonal of ρ, of
    ``targets`` (sorted qubit order) or of the whole register, as a tensor
    on the state's device."""
    if n is None:
        n = rho.shape[-1].bit_length() - 1
    return _marginal(torch.diagonal(rho[0]).clone(), targets, n)
